"""Host-side python-int field and curve arithmetic."""
