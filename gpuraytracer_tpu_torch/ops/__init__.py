"""Hand-written CUDA kernels of the hot paths, with their plain versions."""
from .cuda_path import (OCC_BIT, TraceAux, pregen_draws, render_path_cuda,
                        render_path_cuda_impl)
from .cuda_mis import (MisRecords, render_mis_cuda, render_mis_cuda_impl,
                       render_mis_decoupled)
from .cuda_shade import render_path_decoupled_fused, render_path_fused_local
from .decoupled import render_path_decoupled, shade_replay, trace_records
