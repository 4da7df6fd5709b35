"""Hand-written CUDA kernels of the hot paths, with their plain versions."""
from .cuda_path import (OCC_BIT, TraceAux, pregen_draws, render_path_cuda,
                        render_path_cuda_impl)
from .cuda_mis import MisRecords, render_mis_cuda, render_mis_cuda_impl
from .cuda_mis_bwd import (render_mis_decoupled, render_mis_fused,
                           render_mis_fused_local)
from .cuda_shade import render_path_decoupled_fused, render_path_fused_local
from .cuda_soft import render_direct_soft_fused
from .decoupled import render_path_decoupled, shade_replay, trace_records
