"""Hand-written CUDA kernels of the hot paths, with their plain versions."""
from .cuda_path import (OCC_BIT, TraceAux, pregen_draws, render_path_cuda,
                        render_path_cuda_impl)
from .decoupled import render_path_decoupled, trace_records
