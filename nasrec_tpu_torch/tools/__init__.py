"""Measurement scripts of the port, each run on the card by hand."""
