"""Inputs made on the device from a seed."""
