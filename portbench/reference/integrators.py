"""The two integrators of the plain reference, block by block.

Frozen copies of the port's eager oracles (``gpuraytracer_tpu_torch/
render.py``: ``_path_trace_chunk``, after RTrace/raytrace.metal:11-111, and
``_mis_chunk``, after shaders.metal:519-707), vectorised over (pixel,
sample) lanes and asking a ``trace.Tracer`` for every ray query. Each
function yields (pixel slice, contribution [P, 3]) blocks whose sum over
blocks is the image; a block's contribution is differentiable in the
light's parameters and, through the tracer's materials, in the triangles'.
The blocks and the order of the tracer's calls depend on the shapes alone,
so a replay meets its records in the order they were made.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from . import sampling as smp
from .trace import RAY_TMAX, RAY_TMIN, Tracer


def path_blocks(cam: Dict, resolution, light: Dict, tracer: Tracer,
                pixels: torch.Tensor, offsets: torch.Tensor, spp: int,
                bounces: int, pixel_block: int, sample_block: int,
                dtype) -> Iterator[Tuple[slice, torch.Tensor]]:
    """Variant B: next-event estimation and cosine bounces. ``pixels``:
    flat pixel ids; ``offsets``: their Halton offsets. Yields each block's
    radiance summed over its samples and divided by ``spp``."""
    width = resolution[0]
    for p0 in range(0, pixels.shape[0], pixel_block):
        sl = slice(p0, min(pixels.shape[0], p0 + pixel_block))
        px = (pixels[sl] % width)[:, None]
        py = (pixels[sl] // width)[:, None]
        for s0 in range(0, spp, sample_block):
            n = torch.arange(s0, min(spp, s0 + sample_block),
                             device=pixels.device)
            i_h = offsets[sl][:, None] + n[None, :]
            o, d = smp.camera_ray(cam, resolution, px, py,
                                  smp.halton2(i_h, 0, dtype))
            color = torch.ones_like(d)
            acc = torch.zeros_like(d)
            alive = torch.ones(i_h.shape, dtype=torch.bool,
                               device=pixels.device)
            for b in range(bounces):
                h = tracer.closest(o, d, RAY_TMIN, RAY_TMAX)
                active = alive & h.hit
                # An emissive hit replaces the sum and ends the path.
                acc = torch.where((active & h.is_emissive)[..., None],
                                  h.emissive, acc)
                surf = active & ~h.is_emissive
                t_safe = torch.where(surf, h.t, torch.zeros_like(h.t))
                point = o + d * t_safe[..., None] + h.normal * 1e-3
                lcol, ldir, ldist = smp.sample_area_light(
                    light, point, smp.halton2(i_h, 2 + b * 5, dtype))
                lcol = lcol * torch.clamp(smp.dot(h.normal, ldir),
                                          0.0, 1.0)[..., None]
                color = torch.where(surf[..., None], color * h.diffuse,
                                    color)
                occluded = tracer.blocked(point, ldir, 0.0, ldist - 1e-3)
                acc = acc + torch.where((surf & ~occluded)[..., None],
                                        lcol * color, torch.zeros_like(color))
                sdir = smp.align_hemisphere(smp.cosine_hemisphere_y_up(
                    smp.halton2(i_h, 2 + b * 5 + 2, dtype)), h.normal)
                o = torch.where(surf[..., None], point, o)
                d = torch.where(surf[..., None], sdir, d)
                alive = surf
            yield sl, acc.sum(dim=1) * (1.0 / spp)


def _direct_light(tracer, light, point, normal, in_dir, diffuse, metallic,
                  roughness, u, s_per, weighted: bool, active):
    """Strategy 1, and the unweighted light sample at a bounce point."""
    origin = point + normal * 1e-4
    ldir, ldist = smp.direct_square_light_sample(origin, light, u)
    pdf_l = smp.square_light_pdf(point, light, ldir)
    occluded = tracer.blocked(origin, ldir, RAY_TMIN, ldist * (1.0 - 1e-4))
    contrib = (smp.brdf(in_dir, normal, diffuse, metallic, roughness, ldir)
               * light["emitted_radiance"] / pdf_l[..., None])
    if weighted:
        contrib = contrib * smp.power_heuristic_3(
            pdf_l, smp.cosine_pdf(normal, ldir),
            smp.vndf_pdf(-in_dir, normal, ldir, roughness), s_per)[..., None]
    return torch.where((active & ~occluded)[..., None], contrib,
                       torch.zeros_like(contrib))


def _bounce(tracer, light, point, normal, in_dir, diffuse, metallic,
            roughness, active, sample_dir, pdf_self, weight, sec_u):
    """Strategies 2 and 3: trace the sampled direction; the light term if
    it meets the light, one light sample at the bounce point if it meets a
    surface."""
    origin = point + normal * 1e-4
    h = tracer.closest(origin, sample_dir, RAY_TMIN, RAY_TMAX)
    f = smp.brdf(in_dir, normal, diffuse, metallic, roughness, sample_dir)
    pdf_ok = pdf_self > 0.0
    inv_pdf = torch.where(pdf_ok, 1.0 / torch.where(
        pdf_ok, pdf_self, torch.ones_like(pdf_self)),
        torch.zeros_like(pdf_self))[..., None]
    hit_light = active & h.hit & h.is_emissive
    light_term = weight[..., None] * f * light["emitted_radiance"] * inv_pdf
    hit_geo = active & h.hit & ~h.is_emissive
    bounce_point = origin + sample_dir * torch.where(
        hit_geo, h.t, torch.zeros_like(h.t))[..., None]
    sec = _direct_light(tracer, light, bounce_point, h.normal, sample_dir,
                        h.diffuse, h.metallic, h.roughness, sec_u, 1, False,
                        hit_geo)
    zero = torch.zeros_like(f)
    return (torch.where(hit_light[..., None], light_term, zero)
            + torch.where(hit_geo[..., None], f * inv_pdf * sec, zero))


def mis_blocks(cam: Dict, resolution, light: Dict, tracer: Tracer,
               pixels: torch.Tensor, camera_rays: int, mis_samples: int,
               pixel_block: int, sample_block: int,
               dtype) -> Iterator[Tuple[slice, torch.Tensor]]:
    """Variant A: per camera ray, ``mis_samples // 3`` samples of the light,
    cosine and VNDF strategies under the power heuristic. Yields raw
    accumulated colour (before exposure), summed over camera rays."""
    width = resolution[0]
    s_per = mis_samples // 3
    tables = smp.mis_sample_tables(mis_samples, pixels.device, dtype)
    for p0 in range(0, pixels.shape[0], pixel_block):
        sl = slice(p0, min(pixels.shape[0], p0 + pixel_block))
        px, py = pixels[sl] % width, pixels[sl] // width
        for i in range(camera_rays):
            o, d = smp.camera_ray(cam, resolution, px, py,
                                  smp.hash_random_2d(px, py, i, dtype))
            h = tracer.closest(o, d, RAY_TMIN, RAY_TMAX)
            cam_light = h.hit & h.is_emissive
            yield sl, torch.where(cam_light[..., None],
                                  light["emitted_radiance"].expand(d.shape),
                                  torch.zeros_like(d))
            surf = h.hit & ~h.is_emissive
            point = o + d * torch.where(surf, h.t,
                                        torch.zeros_like(h.t))[..., None]
            for s0 in range(0, s_per, sample_block):
                s1 = min(s_per, s0 + sample_block)
                lu, cu, csu, vu, vsu = (t[s0:s1][None] for t in tables)

                def lane(x):
                    return x[:, None].expand((x.shape[0], s1 - s0)
                                             + x.shape[1:])

                pt, nrm, din = lane(point), lane(h.normal), lane(d)
                dif, met, rgh = lane(h.diffuse), lane(h.metallic), \
                    lane(h.roughness)
                act = lane(surf)
                direct = _direct_light(tracer, light, pt, nrm, din, dif, met,
                                       rgh, lu, s_per, True, act)
                cdir = smp.cosine_weighted_dir(nrm, cu)
                pdf_c = smp.cosine_pdf(nrm, cdir)
                w_c = smp.power_heuristic_3(
                    pdf_c, smp.square_light_pdf(pt, light, cdir),
                    smp.vndf_pdf(-din, nrm, cdir, rgh), s_per)
                cosine = _bounce(tracer, light, pt, nrm, din, dif, met, rgh,
                                 act, cdir, pdf_c, w_c, csu)
                vdir = smp.vndf_dir(-din, nrm, rgh, vu)
                pdf_v = smp.vndf_pdf(-din, nrm, vdir, rgh)
                w_v = smp.power_heuristic_3(
                    pdf_v, smp.square_light_pdf(pt, light, vdir),
                    smp.cosine_pdf(nrm, vdir), s_per)
                vndf = _bounce(tracer, light, pt, nrm, din, dif, met, rgh,
                               act, vdir, pdf_v, w_v, vsu)
                total = (direct + cosine + vndf).sum(dim=1) * (1.0 / s_per)
                yield sl, torch.where(surf[..., None], total,
                                      torch.zeros_like(total))
