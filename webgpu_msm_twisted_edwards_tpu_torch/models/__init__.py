"""The MSM entry point."""
