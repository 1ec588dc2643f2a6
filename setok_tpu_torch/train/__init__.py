"""Trainers and their parameter transformations."""
