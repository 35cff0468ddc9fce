"""The MSM pipeline and its stages."""
