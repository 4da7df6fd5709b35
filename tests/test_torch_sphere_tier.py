"""Scenes of at most 64 triangles with many spheres: the tier rule, the
shared-memory plans, and the port's fused route against the JAX package.

``cuda_path.grouped_tier`` sends a route to the grouped tier above 64
triangles, as the JAX entry does, and also where a static kernel that the
route launches cannot stage its tables in one block's shared memory (227 KiB
on sm_90); each route passes its kernels' plans: K2 and K3 for the fused
path route (``cuda_shade.fused_tier``), K4 and K5 for the fused MIS route
(``cuda_mis_bwd.fused_tier``). A trace that runs alone passes its own plan
with the measured size past which its grouped tier is the faster
(``TRACE_ALONE_BYTES``). The first part holds the rule and the plans as
pure Python: every scene ``chip_smoke.py`` ran before keeps its tier on
every route, box+300 (the sphere scene with 300 small spheres, 314
primitives) stays static, box+1000 (1,014) takes the grouped tier but for
the MIS trace alone, and the limits come out of the plans.

The second part holds the port's fused route on the CPU (its plain
versions, under the rule: K2g's plain sweep on box+1000) against the JAX
package's jnp oracle (``render.render``, its forward and vjp compiled once
for the three scenes at XLA's level 0, which contracts no multiply-add, as
the port does not) at 16 x 12 x 2 spp x 2 bounces, on box+300, box+1000 and
the in-view 169-primitive scene (``chip_smoke.spheres_at_static_limit(
in_view=True)``), each built from one numpy seed in both packages and
carried across by ``convert``.

Tolerances: the North star's path tolerances, values atol 2e-5 / rtol 1e-4
and gradients atol 1e-6 / rtol 1e-4, hold on every pixel whose paths meet
none of the added small spheres (the values there, and all 12 gradient
groups of the mean over those pixels), and on every pixel for the groups
whose gradient does not go through the sphere quadratic on a camera ray
(light, triangles, sphere albedo). Where a camera ray meets a small sphere
every float32 evaluation of the reference's arithmetic lies 4-11 % of a
lane's size from float64 (``tools/sphere_conditioning.py``): two
evaluations of the JAX package itself that differ only in rounding (level 0
and op by op) lie up to 43 times the tolerances apart there. So the values
and the camera and sphere geometry groups of the whole frame are held at
SPREAD times the tolerances, which the port meets (at most 36 times against
level 0) and the JAX package's default jit, whose fused multiply-adds move
the same lanes, misses on box+300 and the in-view scene (175 and 332 times
against level 0); ``PYTHONPATH=. python tests/test_torch_sphere_tier.py``
prints every reading (PERF.md §6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
from gpuraytracer_tpu.render import render as jax_render
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch.ops import (cuda_mis, cuda_mis_bwd, cuda_path,
                                        cuda_shade, decoupled)
from gpuraytracer_tpu_torch.scene import (cornell_box, cornell_box_glossy,
                                          cornell_box_tessellated,
                                          cornell_box_with_spheres)
from gpuraytracer_tpu_torch.types import RenderConfig

LIMIT = 227 * 1024  # one block's most on sm_90
HDR_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
CFG = dict(width=16, height=12, integrator="path", spp=2, bounces=2,
           pixel_chunk=192)
# The groups whose gradient goes through the sphere quadratic's root where a
# camera ray meets a small sphere, and the rest.
ILL_CONDITIONED = ("camera.position", "camera.direction", "camera.up",
                   "spheres.center", "spheres.radius")
WELL_CONDITIONED = ("light.color", "light.center", "light.normal",
                    "triangles.verts", "triangles.diffuse",
                    "triangles.emissive", "spheres.diffuse")
SPHERE_GROUPS = WELL_CONDITIONED + ILL_CONDITIONED
# Two float32 evaluations of the JAX package, compiled at XLA's level 0 and
# op by op, lie up to 43 times the North star's tolerances apart on the
# values and the ill-conditioned groups of these scenes, and the port from
# either up to 48 times; the JAX package's default jit, whose fused
# multiply-adds move the same lanes, lies up to 335 times from them
# (``PYTHONPATH=. python tests/test_torch_sphere_tier.py``, PERF.md §6).
# The whole frame is held between the two.
SPREAD = 100
# name -> (added spheres, seed, radii, emissive ones): chip_smoke.py's
# MANY_SPHERES and the in-view probe scene (PROBE_PRIMS).
SCENES = {
    "box+300": (300, cs.MANY_SPHERES_SEED, cs.MANY_SPHERES_RADII, 1),
    "box+1000": (1000, cs.MANY_SPHERES_SEED, cs.MANY_SPHERES_RADII, 0),
    "in-view": (cs.PROBE_PRIMS - 14, cs.PROBE_PRIMS, (0.1, 0.3), 0),
}


# ---------------------------------------------------------------------------
# The tier rule and the plans (pure Python)
# ---------------------------------------------------------------------------

# Every scene chip_smoke.py rendered before the rule took table size into
# account, at the sample counts it renders MIS at: its tier is still the
# triangle count's.
OLD_SCENES = {
    "cornell": lambda r: cornell_box(resolution=r),
    "cornell-spheres": lambda r: cornell_box_with_spheres(resolution=r),
    "cornell-glossy": lambda r: cornell_box_glossy(resolution=r),
    "tess-252": lambda r: cornell_box_tessellated(resolution=r, **cs.TESS_SMALL),
    "tess-1002": lambda r: cornell_box_tessellated(resolution=r, **cs.TESS_K),
    "tess-1282": lambda r: cornell_box_tessellated(resolution=r, **cs.TESS_1282),
    "tess-12802": lambda r: cornell_box_tessellated(resolution=r, **cs.TESS_L),
    "tess-252+spheres": cs.tess_with_spheres,
    "hidden emitter": cs.tess_with_hidden_emitter,
    "169 hidden": lambda r: cs.spheres_at_static_limit(r),
    "169 in view": lambda r: cs.spheres_at_static_limit(r, in_view=True),
    "soft limit": cs.soft_scene_at_limit,
}


def _tiers(scene, samples, occluders=None):
    """The tier of each route on ``scene``: the path tracer's trace alone
    and with its backward, the MIS trace alone and with its backward."""
    return (cuda_path.grouped_tier(scene, cuda_path.trace_plan(
                scene, occluders, alone=True)),
            cuda_shade.fused_tier(scene, occluders),
            cuda_path.grouped_tier(scene, cuda_mis.mis_plan(
                scene, occluders, samples, alone=True)),
            cuda_mis_bwd.fused_tier(scene, samples, occluders))


@pytest.mark.parametrize("name", sorted(OLD_SCENES))
def test_earlier_scenes_keep_their_tier(name):
    scene = OLD_SCENES[name]((16, 12))
    grouped = scene.triangles.num_triangles > cuda_path.STATIC_TIER_MAX
    for samples in (12, 30, 300, 2700):
        assert _tiers(scene, samples) == (grouped,) * 4


@pytest.mark.parametrize("name, grouped", [("box+300", False),
                                           ("box+1000", True)])
def test_many_spheres_take_their_tier_on_both_routes(name, grouped):
    """box+1000: the routes that run a backward go grouped (K3's and K5's
    tables pass a block), and so does the path trace alone (K2's 69,912 B
    pass TRACE_ALONE_BYTES); the MIS trace alone stays static (K4's 66-72
    KB do not pass its own)."""
    scene = cs.box_with_many_spheres(name, (16, 12))
    assert scene.triangles.num_triangles == 12
    for occluders in (None, (True,) * 10 + (False, False)):
        for samples in (30, 300):
            assert _tiers(scene, samples, occluders) == (
                grouped, grouped, False, grouped)


def test_static_limits_come_from_the_plans():
    # K3: 288 P + 8,100 B with spheres, within 232,448 B up to 778
    # primitives; the fused path route goes grouped at 779.
    assert cs.static_bwd_max_sph() == 778
    at = cs.spheres_at_static_limit((4, 3), prims=778)
    past = cs.spheres_at_static_limit((4, 3), prims=779)
    assert not cuda_shade.fused_tier(at)
    assert cuda_shade.fused_tier(past)
    # K5 at 300 MIS samples: 4 (75 P + 16 100 + 5 29) B, static up to 751
    # primitives; K4 takes both (4 (16 100 + 16 S + 24 12 + 12 12) B).
    assert cuda_mis_bwd.static_smem_bytes(100, 751, 15) == 232280 <= LIMIT
    assert not cuda_mis_bwd.fused_tier(
        cs.spheres_at_static_limit((4, 3), prims=751), 300)
    assert cuda_mis_bwd.fused_tier(
        cs.spheres_at_static_limit((4, 3), prims=752), 300)
    assert not cuda_mis_bwd.fused_tier(
        cs.spheres_at_static_limit((4, 3), prims=752), 30)
    # A trace alone: K2 4 (12 (12 + 12) + 4 S + 13 (12 + S)) B within 37,888
    # B (six blocks of 128 per SM) up to 531 spheres; K4 at 30 MIS samples
    # 4 (16 10 + 4 S + 12 (12 + 12) + 12 (12 + S)) B within 76,800 B (three
    # blocks) up to 1,163.
    assert cuda_path.TRACE_ALONE_BYTES == 37888
    assert cuda_mis.TRACE_ALONE_BYTES == 76800
    for spheres, grouped in ((531, False), (532, True)):
        box = cs.spheres_at_static_limit((4, 3), prims=12 + spheres)
        assert cuda_path.grouped_tier(box, cuda_path.trace_plan(
            box, alone=True)) == grouped
        assert not cuda_path.grouped_tier(box, cuda_path.trace_plan(box))
    for spheres, grouped in ((1163, False), (1164, True)):
        box = cs.spheres_at_static_limit((4, 3), prims=12 + spheres)
        assert cuda_path.grouped_tier(box, cuda_mis.mis_plan(
            box, None, 30, alone=True)) == grouped


# (plan, arguments) -> bytes at box+300 (302 spheres) and box+1000 (1,002),
# the C formulas written out: K2 4 (12 (T + n_shadow) + 4 S + 13 (T + S)),
# K3 4 (16 P + 21 + 4 (14 P + 21) + 128 15), K4 4 (16 s_per + 4 S + 12 (T +
# n_shadow) + 12 (T + S)), K5 4 (15 P + 16 s_per + 29 + 4 (15 P + 29)).
@pytest.mark.parametrize("plan, args, expected", [
    ("k2", (12, 12, 302), 4 * (12 * 24 + 4 * 302 + 13 * 314)),
    ("k2", (12, 12, 1002), 4 * (12 * 24 + 4 * 1002 + 13 * 1014)),
    ("k3", (314, True), 4 * (16 * 314 + 21 + 4 * (314 * 14 + 21) + 128 * 15)),
    ("k4", (100, 302, 12, 12), 4 * (1600 + 4 * 302 + 12 * 24 + 12 * 314)),
    ("k4", (100, 1002, 12, 12), 4 * (1600 + 4 * 1002 + 12 * 24 + 12 * 1014)),
    ("k5", (100, 314, 15), 4 * (15 * 314 + 1600 + 29 + 4 * (314 * 15 + 29))),
])
def test_plans_at_the_sphere_scenes_are_the_c_formulas(plan, args, expected):
    fn = {"k2": cuda_path.static_smem_bytes, "k3": cuda_shade.static_smem_bytes,
          "k4": cuda_mis.static_smem_bytes,
          "k5": cuda_mis_bwd.static_smem_bytes}[plan]
    assert fn(*args) == expected <= LIMIT


def test_box_300_opts_k3_in_and_box_1000_passes_the_static_plans():
    # box+300: K3's block 98,532 B, opted in past 48 KiB, two per SM.
    smem = cuda_shade.static_smem_bytes(314, True)
    assert 48 * 1024 < smem == 98532 and 2 * (smem + 1024) <= 228 * 1024
    # box+1000: K3's and K5's static tables pass one block's most.
    with pytest.raises(ValueError, match=str(LIMIT)):
        cuda_shade.static_smem_bytes(1014, True)
    for s_per in (10, 100):  # 30 and 300 MIS samples
        with pytest.raises(ValueError, match=str(LIMIT)):
            cuda_mis_bwd.static_smem_bytes(s_per, 1014, 15)
    # K3g's grid at 512 x 512: 4 blocks per SM hold every block, their
    # warp tables (14,217 floats each) some 120 MB.
    blocks = cuda_shade.grouped_blocks(512 * 512, 1014, True, 4, 132)
    assert blocks == 528 and 4 * blocks * 4 * (1014 * 14 + 21) < 2 ** 27


# ---------------------------------------------------------------------------
# The port's fused route against the JAX package
# ---------------------------------------------------------------------------

def _jax_scene(name):
    n, seed, radii, emissive = SCENES[name]
    base = jscene.cornell_box_with_spheres(resolution=(16, 12))
    extra = jscene.make_spheres(*cs.box_sphere_arrays(n, seed, radii,
                                                      emissive=emissive))
    own = base.spheres
    return dataclasses.replace(base, spheres=dataclasses.replace(own, **{
        f.name: np.concatenate([np.asarray(getattr(extra, f.name)),
                                np.asarray(getattr(own, f.name))])
        for f in dataclasses.fields(own)}))


def _with_grad(scene):
    return scene.map(lambda t: t.detach().clone().requires_grad_(
        t.is_floating_point()))


def _port(scene, cfg, weights):
    """hdr and, for each [H, W] weight, the gradients of sum(weight * hdr) /
    hdr.numel() through the fused route (its plain versions on the CPU,
    under the tier rule)."""
    grads = []
    for weight in weights:
        leaves = _with_grad(scene)
        hdr = cuda_shade.render_path_decoupled_fused(leaves, cfg, device="cpu")
        ((hdr * torch.from_numpy(weight)[..., None]).sum()
         / hdr.numel()).backward()
        grads.append(convert.grads_to_numpy(leaves))
    return hdr.detach().numpy(), grads


def _pixel_classes(scene, cfg, n_added):
    """[H, W] masks from the port's records: the camera ray of some sample
    meets one of the added spheres (the table's columns 12 .. 12 + n_added);
    only a later bounce meets one; none does (clear)."""
    _, aux = decoupled.trace_records(scene, cfg, device="cpu")
    prim = (aux.records % cuda_path.OCC_BIT).long() - 1
    added = (prim >= 12) & (prim < 12 + n_added)
    camera = added[:, 0].any(dim=0)
    later = added.any(dim=0).any(dim=0) & ~camera
    shape = (cfg.height, cfg.width)
    return {"whole": np.ones(shape, bool),
            "clear": (~(camera | later)).reshape(shape).numpy(),
            "camera ray": camera.reshape(shape).numpy(),
            "later bounce": later.reshape(shape).numpy()}, aux


# The JAX side pads every scene's sphere list to one length with copies of
# its last sphere, so that one compile serves the three scenes: a copy never
# wins the closest hit (argmin takes the lowest index of a tie) and blocks
# no shadow ray the original does not.
JAX_SPHERES = max(n for n, *_ in SCENES.values()) + 2
# XLA's CPU backend contracts products and sums into fused multiply-adds at
# its default optimization level; at level 0 it does not. The port computes
# without them, as its kernels do (-fmad=false), so it is held against the
# JAX package compiled at level 0.
NO_FMA = (("xla_backend_optimization_level", 0),)


def _padded(jax_scene):
    sp = jax_scene.spheres
    pad = JAX_SPHERES - sp.num_spheres
    return dataclasses.replace(jax_scene, spheres=dataclasses.replace(sp, **{
        f.name: np.concatenate([getattr(sp, f.name)]
                               + [getattr(sp, f.name)[-1:]] * pad)
        for f in dataclasses.fields(sp)}))


def _jax_side(jax_scene, weights):
    """The JAX oracle's hdr and, from one backward pass, the gradients of
    sum(weight * hdr) / hdr.size for each of ``weights`` [k, H, W]."""
    jcfg = jtypes.RenderConfig(**CFG)
    hdr, pull = jax.vjp(lambda s: jax_render(s, jcfg).hdr, jax_scene)
    return hdr, jax.vmap(pull)(weights[..., None] * jnp.ones_like(hdr)
                               / hdr.size)[0]


@functools.lru_cache(maxsize=None)
def _compiled(k, options):
    """``_jax_side`` compiled once for k weights with these XLA options."""
    example = _padded(_jax_scene("in-view"))
    weights = np.zeros((k, CFG["height"], CFG["width"]), np.float32)
    return jax.jit(_jax_side).lower(example, weights).compile(dict(options))


def _jax(jax_scene, weights, options=NO_FMA):
    """(hdr, [gradient tree per weight]), the spheres cut back to the
    scene's own; ``options`` None evaluates op by op (``jax.disable_jit``)."""
    if options is None:
        with jax.disable_jit():
            hdr, grads = _jax_side(jax_scene, jnp.asarray(weights))
        n_sph = None
    else:
        hdr, grads = _compiled(len(weights), options)(_padded(jax_scene),
                                                      weights)
        n_sph = jax_scene.spheres.num_spheres
    return np.asarray(hdr), [jax.tree_util.tree_map_with_path(
        lambda path, x, k=k: np.asarray(x[k])[:n_sph]
        if "spheres" in jax.tree_util.keystr(path) else np.asarray(x[k]),
        grads) for k in range(len(weights))]


def _group(tree, group):
    part, field = group.split(".")
    if isinstance(tree, dict):  # the port's tree
        return tree[part][field]
    return np.asarray(getattr(getattr(tree, part), field))


@functools.lru_cache(maxsize=None)
def _case(name):
    """Everything the checks of one scene read, computed once: the port and
    the JAX package (no FMA) on the whole frame and on the clear pixels."""
    jax_scene = _jax_scene(name)
    scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))
    cfg = RenderConfig(**CFG)
    classes, _ = _pixel_classes(scene, cfg, SCENES[name][0])
    weights = np.stack([classes["whole"], classes["clear"]]).astype(
        np.float32)
    hdr_j, grads_j = _jax(jax_scene, weights)
    hdr_p, grads_p = _port(scene, cfg, weights)
    return dict(scene=scene, cfg=cfg, clear=classes["clear"], hdr_j=hdr_j,
                grads_j=grads_j, hdr_p=hdr_p, grads_p=grads_p)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_is_chip_smokes(name):
    """The scene built from the JAX package and carried across is the one
    chip_smoke.py builds in the port, tensor for tensor."""
    got = _case(name)["scene"]
    want = (cs.spheres_at_static_limit((16, 12), in_view=True)
            if name == "in-view" else cs.box_with_many_spheres(name, (16, 12)))
    assert convert.scenes_equal(got, want)


def test_rule_tier_and_forced_static_trace_agree_on_box_1000():
    """The rule takes the grouped tier (K2g's plain sweep); the static
    trace forced onto the same scene makes the same decisions and image."""
    case = _case("box+1000")
    scene, cfg = case["scene"], case["cfg"]
    assert cuda_shade.fused_tier(scene)
    rule = decoupled.trace_records(scene, cfg, device="cpu")
    forced = cuda_path.render_path_cuda_impl(
        scene, cfg, emit_records=True, grouped=False, device="cpu")
    assert torch.equal(rule[1].records, forced[1].records)
    assert torch.equal(rule[0], forced[0])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_values_match_jax_clear_of_small_spheres(name):
    case = _case(name)
    clear = case["clear"]
    assert clear.mean() > 0.2, "too few pixels clear of the added spheres"
    np.testing.assert_allclose(case["hdr_p"][clear], case["hdr_j"][clear],
                               **HDR_TOL)


@pytest.mark.parametrize("name, group", [(n, g) for n in sorted(SCENES)
                                         for g in SPHERE_GROUPS])
def test_grads_match_jax_clear_of_small_spheres(name, group):
    """Gradients of the mean over the pixels clear of the added spheres."""
    case = _case(name)
    got = _group(case["grads_p"][1], group)
    ref = _group(case["grads_j"][1], group)
    assert got is not None and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("name, group", [(n, g) for n in sorted(SCENES)
                                         for g in WELL_CONDITIONED])
def test_grads_match_jax_on_the_whole_frame(name, group):
    """The groups that do not go through the sphere quadratic's root on the
    camera ray, on every pixel, small spheres included."""
    case = _case(name)
    got = _group(case["grads_p"][0], group)
    ref = _group(case["grads_j"][0], group)
    assert got is not None and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **GRAD_TOL)


@pytest.mark.parametrize("name, group", [(n, g) for n in sorted(SCENES)
                                         for g in ("hdr",) + ILL_CONDITIONED])
def test_whole_frame_within_the_references_own_spread(name, group):
    """The values and the geometry groups on every pixel: within SPREAD
    times the North star's tolerances of the JAX package, the distance at
    which two float32 evaluations of the JAX package itself lie apart."""
    case = _case(name)
    if group == "hdr":
        got, ref, tol = case["hdr_p"], case["hdr_j"], HDR_TOL
    else:
        got = _group(case["grads_p"][0], group)
        ref = _group(case["grads_j"][0], group)
        tol = GRAD_TOL
    assert got is not None and got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=SPREAD * tol["atol"],
                               rtol=SPREAD * tol["rtol"])


# ---------------------------------------------------------------------------
# Readings: PYTHONPATH=. python tests/test_torch_sphere_tier.py
# ---------------------------------------------------------------------------

def _exact(scene, cfg, aux, weights):
    """The fused route's value and gradients in float64: the replay of the
    port's records and draws, its views in float64."""
    grads = []
    for weight in weights:
        leaves = scene.map(lambda t: t.detach().clone().to(
            torch.float64 if t.is_floating_point() else t.dtype
        ).requires_grad_(t.is_floating_point()))
        views = [v.double() for v in cuda_shade._pack_diff_inputs(leaves, cfg)]
        lum = cuda_shade.replay_packed(*views, aux.records,
                                       [d.double() for d in aux[1:]], cfg)
        hdr = (lum / cfg.spp).T.reshape(cfg.height, cfg.width, 3)
        ((hdr * torch.from_numpy(weight).double()[..., None]).sum()
         / hdr.numel()).backward()
        grads.append(convert.grads_to_numpy(leaves))
    return hdr.detach().numpy(), grads


def _worst(got, ref, tol):
    """The largest |got - ref| / (atol + rtol |ref|): 1 is the tolerance."""
    return float((np.abs(got - ref)
                  / (tol["atol"] + tol["rtol"] * np.abs(ref))).max())


def readings(names=tuple(sorted(SCENES))):
    """For each scene and each class of pixels, every group's distance
    between the port, the JAX package without FMA (level 0), with FMA (its
    default jit), op by op and the float64 evaluation of the port's records,
    in units of the North star's tolerances (the values' for hdr)."""
    pairs = [("port", "jax"), ("port", "op by op"), ("jax", "op by op"),
             ("jax fma", "jax"), ("jax fma", "op by op"), ("port", "f64"),
             ("jax", "f64"), ("jax fma", "f64")]
    print("| scene | pixels | group | " + " | ".join(f"{a} - {b}"
                                                     for a, b in pairs) + " |")
    print("|---" * (3 + len(pairs)) + "|")
    for name in names:
        jax_scene = _jax_scene(name)
        scene = convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))
        cfg = RenderConfig(**CFG)
        classes, aux = _pixel_classes(scene, cfg, SCENES[name][0])
        weights = np.stack(list(classes.values())).astype(np.float32)
        runs = {"port": _port(scene, cfg, weights),
                "jax": _jax(jax_scene, weights),
                "jax fma": _jax(jax_scene, weights, ()),
                "op by op": _jax(jax_scene, weights, None),
                "f64": _exact(scene, cfg, aux, weights)}
        for k, label in enumerate(classes):
            rows = [("hdr", lambda r: r[0], HDR_TOL)] if k == 0 else []
            rows += [(g, lambda r, g=g: _group(r[1][k], g), GRAD_TOL)
                     for g in SPHERE_GROUPS]
            for group, pick, tol in rows:
                print(f"| {name} | {label} ({int(classes[label].sum())}) | "
                      f"{group} | " + " | ".join(
                          f"{_worst(pick(runs[a]), pick(runs[b]), tol):.3g}"
                          for a, b in pairs) + " |", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    readings()
