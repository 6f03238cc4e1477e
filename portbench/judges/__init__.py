"""How `correct` is decided, one module per configuration `entry`."""
