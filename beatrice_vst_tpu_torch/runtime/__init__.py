"""The real-time engine of the port."""
