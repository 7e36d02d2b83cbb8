"""Multi-device execution over an explicit list of torch devices."""
