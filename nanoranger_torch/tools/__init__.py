"""Host-side utility CLIs (multi-host input sharding, etc.)."""
