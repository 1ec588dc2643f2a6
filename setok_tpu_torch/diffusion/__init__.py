"""Gaussian diffusion for the MAR head's training loss."""
