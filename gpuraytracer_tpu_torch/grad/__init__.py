"""Differentiable and inverse rendering on top of the render entry points:
``diff_render`` (the edge-aware direct-lighting oracle) and ``inverse``
(pixel losses and the fitting loop)."""
from .diff_render import render_direct_soft
