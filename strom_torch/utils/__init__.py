"""Process-wide helpers of the port: the stats registry and the byte codec."""
