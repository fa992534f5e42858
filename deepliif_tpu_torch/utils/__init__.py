"""Host utilities of the port: checkpoint loading and the weight bridge."""
