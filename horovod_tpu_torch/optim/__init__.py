"""Distributed optimizer and train step."""
