"""The loops a window drives, one module per path of the program; a
configuration names its driver."""
