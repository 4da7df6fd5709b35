"""Brute-force ray queries of the plain reference, with their decisions kept.

Every ray is tested against every triangle (the plane and dual-basis form of
``gpuraytracer_tpu_torch.intersect``): the closest hit is the first minimum
of t, a probe is blocked by any hit inside its window. The tests run in
blocks of rays as two matrix products (origins and directions against the
stacked normals and dual bases) and elementwise tests.

A ``Tracer`` answers the integrators' queries in one of three modes:

* ``direct``: test and answer;
* ``record``: test, answer, and keep each answer in call order;
* ``replay``: answer from the kept answers, in the same order, without a
  test.

The scenes' geometry is held fixed in every cell, and no random draw depends
on a parameter, so a fit's decisions are the same at every step: the
reference tests once and replays the later steps. Shading attributes are
gathered from the tensors the caller passes, so the gradients of a replay
reach them.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from .sampling import cross, dot

RAY_TMIN = 1e-3
RAY_TMAX = 1e3
_BIG = 1e30
# Elements of a [rays, triangles] block.
BLOCK_ELEMENTS = 1 << 25


class Hit(NamedTuple):
    hit: torch.Tensor
    t: torch.Tensor
    normal: torch.Tensor
    diffuse: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    emissive: torch.Tensor
    is_emissive: torch.Tensor


def compile_triangles(verts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-triangle plane (n, c0) and dual basis (s1, c1, s2, c2)."""
    v0 = verts[:, 0]
    e1, e2 = verts[:, 1] - v0, verts[:, 2] - v0
    n_raw = cross(e1, e2)
    n = n_raw * (1.0 / torch.sqrt(torch.clamp_min(dot(n_raw, n_raw),
                                                  1e-30)))[..., None]
    e11, e22, e12 = dot(e1, e1), dot(e2, e2), dot(e1, e2)
    denom = torch.clamp_min(e11 * e22 - e12 * e12, 1e-30)
    s1 = (e22[..., None] * e1 - e12[..., None] * e2) / denom[..., None]
    s2 = (e11[..., None] * e2 - e12[..., None] * e1) / denom[..., None]
    return dict(n=n, c0=dot(n, v0), s1=s1, c1=dot(v0, s1), s2=s2,
                c2=dot(v0, s2))


class _Gather(torch.autograd.Function):
    """``table[idx]`` whose backward adds the rows' cotangents with
    ``index_add_``: autograd's own index backward sorts millions of indices
    into a few dozen rows, one at a time. The sums' order is the card's, so
    their last bits may differ from run to run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        tail = grad.shape[idx.dim():]
        out = torch.zeros((ctx.rows,) + tail, dtype=grad.dtype,
                          device=grad.device)
        out.index_add_(0, idx.reshape(-1), grad.reshape((-1,) + tail))
        return out, None


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return (_Gather.apply(table, idx) if table.requires_grad
            else table[idx])


class Tracer:
    """Closest-hit and probe queries against one triangle scene.

    ``geo``: ``compile_triangles``' constants. ``mat``: the shading
    attributes per triangle (diffuse, metallic, roughness, emissive), set
    with ``set_materials`` before each pass."""

    def __init__(self, geo: Dict[str, torch.Tensor], mode: str = "direct"):
        self.geo = geo
        t = geo["n"].shape[0]
        self.n_tris = t
        # [4, 3T]: normals, then the two dual bases, over their offsets, so
        # that [o, 1] times it gives o.n - c0, o.s1 - c1 and o.s2 - c2.
        self.stack = torch.cat([
            torch.cat([geo["n"], geo["s1"], geo["s2"]], 0).T,
            -torch.cat([geo["c0"], geo["c1"], geo["c2"]])[None]], 0) \
            .contiguous()
        self.mode = mode
        self.records: List = []
        self.cursor = 0
        self.mat: Dict[str, torch.Tensor] = {}
        self.prim_dtype = torch.int16 if t < 32767 else torch.int32

    def set_materials(self, diffuse, metallic, roughness, emissive) -> None:
        self.mat = dict(diffuse=diffuse, metallic=metallic,
                        roughness=roughness, emissive=emissive,
                        is_emissive=torch.linalg.norm(
                            emissive.float(), dim=-1) > 0.0)

    def start(self, mode: str) -> None:
        """Begin a pass: ``record`` drops the kept answers."""
        self.mode = mode
        self.cursor = 0
        if mode == "record":
            self.records = []

    def _tests(self, o, d, t_min, t_max):
        """t [r, T] and validity [r, T] for a block of rays. A ray parallel
        to a plane gets an infinite or undefined t, which no window
        holds."""
        t_count = self.n_tris
        ones = torch.ones_like(o[:, :1])
        po = torch.cat([o, ones], 1) @ self.stack
        pd = d @ self.stack[:3]
        t = po[:, :t_count] / pd[:, :t_count]
        t.neg_()
        u = torch.addcmul(po[:, t_count:2 * t_count], t,
                          pd[:, t_count:2 * t_count])
        v = torch.addcmul(po[:, 2 * t_count:], t, pd[:, 2 * t_count:])
        if isinstance(t_max, torch.Tensor):
            t_max = t_max[:, None]
        valid = (t > t_min) & (t < t_max)
        valid &= torch.minimum(u, v) >= 0.0
        valid &= (u + v) <= 1.0
        return t, valid

    def _blocks(self, n: int):
        step = max(1, BLOCK_ELEMENTS // max(self.n_tris, 1))
        return [(s, min(n, s + step)) for s in range(0, n, step)]

    def _closest_test(self, o, d, t_min, t_max):
        n = o.shape[0]
        prim = torch.empty(n, dtype=torch.int64, device=o.device)
        t_hit = torch.empty(n, dtype=o.dtype, device=o.device)
        with torch.no_grad():
            for s, e in self._blocks(n):
                t, valid = self._tests(o[s:e], d[s:e], t_min, t_max)
                tm = torch.where(valid, t, torch.full_like(t, _BIG))
                idx = torch.argmin(tm, dim=-1)
                best = torch.gather(tm, -1, idx[:, None])[:, 0]
                ok = best < _BIG
                prim[s:e] = torch.where(ok, idx, torch.full_like(idx, -1))
                t_hit[s:e] = best
        return prim, t_hit

    def _any_test(self, o, d, t_min, t_max):
        n = o.shape[0]
        out = torch.empty(n, dtype=torch.bool, device=o.device)
        with torch.no_grad():
            for s, e in self._blocks(n):
                tm = t_max[s:e] if isinstance(t_max, torch.Tensor) else t_max
                _, valid = self._tests(o[s:e], d[s:e], t_min, tm)
                out[s:e] = valid.any(dim=-1)
        return out

    def _next(self):
        rec = self.records[self.cursor]
        self.cursor += 1
        return rec

    def closest(self, o, d, t_min=RAY_TMIN, t_max=RAY_TMAX) -> Hit:
        shape = o.shape[:-1]
        if self.mode == "replay":
            prim, t_hit = self._next()
            prim = prim.to(torch.int64)
        else:
            prim, t_hit = self._closest_test(
                o.detach().reshape(-1, 3), d.detach().reshape(-1, 3),
                t_min, t_max)
            if self.mode == "record":
                self.records.append((prim.to(self.prim_dtype), t_hit))
        hit = (prim >= 0).reshape(shape)
        idx = prim.clamp_min(0).reshape(shape)
        t_hit = torch.where(hit, t_hit.reshape(shape),
                            torch.full_like(t_hit.reshape(shape), _BIG))
        m = self.mat
        return Hit(hit=hit, t=t_hit, normal=self.geo["n"][idx],
                   diffuse=gather(m["diffuse"], idx),
                   metallic=m["metallic"][idx],
                   roughness=m["roughness"][idx],
                   emissive=m["emissive"][idx],
                   is_emissive=m["is_emissive"][idx])

    def blocked(self, o, d, t_min, t_max) -> torch.Tensor:
        shape = o.shape[:-1]
        if self.mode == "replay":
            return self._next().reshape(shape)
        tm = (t_max.detach().reshape(-1) if isinstance(t_max, torch.Tensor)
              else t_max)
        out = self._any_test(o.detach().reshape(-1, 3),
                             d.detach().reshape(-1, 3), t_min, tm)
        if self.mode == "record":
            self.records.append(out)
        return out.reshape(shape)
