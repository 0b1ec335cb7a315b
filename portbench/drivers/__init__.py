"""Drivers: one module per entry point of the program a window drives."""
