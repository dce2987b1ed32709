"""Physical operators and the device-cached relation."""
