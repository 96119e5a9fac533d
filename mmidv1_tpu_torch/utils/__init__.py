"""Exceptions, logging and device selection of the port."""
