"""Point-axis sharding of the port over the devices of one process."""
