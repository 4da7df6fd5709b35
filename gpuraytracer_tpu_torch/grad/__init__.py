"""Differentiable and inverse rendering on top of the render entry points."""
