"""Sharded rendering and training over ``torch.distributed``.

Counterpart of ``gpuraytracer_tpu/parallel/``: pixels shard over a ``rays``
axis of ranks (and samples over an ``spp`` axis), the scene is replicated,
and the parameter gradients are summed across ranks. NCCL carries the
collectives between cards, gloo on the CPU.

  * ``multihost``  ``init_distributed`` (from torch's launcher environment),
                   ``is_primary``, ``gather_image``, ``sync_hosts``
  * ``mesh``       ``RayMesh``, the two autograd Functions (``gather``,
                   ``replicate``), the sharded eager oracle
  * ``fast``       the sharded fused kernel paths (variant B and MIS) and
                   the overlapped gradient all-reduce
  * ``train``      the sharded training step
"""
