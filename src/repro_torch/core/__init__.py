"""Flat compression, collectives and the variance monitor."""
