"""The code that runs the port, one module per configuration `entry`."""
