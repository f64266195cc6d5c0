"""Frozen copies of the port's planar physics and rewards."""
