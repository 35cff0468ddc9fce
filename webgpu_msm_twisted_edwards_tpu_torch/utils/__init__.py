"""Parameters, codecs, device facts and the native oracle binding."""
