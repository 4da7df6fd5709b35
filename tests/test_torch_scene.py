"""PyTorch port vs the JAX package: scenes, compiled constants, occluder
masks and the render configuration.

A scene crosses between the packages as a tree of numpy arrays
(``convert.scene_from_numpy``); the port's own constructors must produce the
same bits as the JAX package's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpuraytracer_tpu.intersect as jint
import gpuraytracer_tpu.scene as jscene
import gpuraytracer_tpu.types as jtypes
import gpuraytracer_tpu_torch as port
from gpuraytracer_tpu_torch import convert
from gpuraytracer_tpu_torch import intersect as tint
from gpuraytracer_tpu_torch import scene as tscene
from gpuraytracer_tpu_torch.types import RenderConfig

SCENES = {
    "cornell": (jscene.cornell_box, tscene.cornell_box),
    "cornell-spheres": (jscene.cornell_box_with_spheres,
                        tscene.cornell_box_with_spheres),
}
# Walls and light panel (12 triangles); the box scene adds two boxes of 12.
NUM_TRIANGLES = {"cornell": 36, "cornell-spheres": 12}


def _pair(name, resolution=(32, 16)):
    jax_ctor, port_ctor = SCENES[name]
    jax_scene = jax_ctor(resolution=resolution)
    carried = convert.scene_from_numpy(jax.tree.map(np.asarray, jax_scene))
    return jax_scene, carried, port_ctor(resolution=resolution)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_carried_scene_equals_port_constructor(name):
    _, carried, own = _pair(name)
    assert convert.scenes_equal(carried, own)
    assert carried.triangles.num_triangles == NUM_TRIANGLES[name]
    assert carried.triangles.verts.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_numpy_round_trip(name):
    jax_scene, carried, own = _pair(name)
    tree = convert.scene_to_numpy(own)
    assert convert.scenes_equal(convert.scene_from_numpy(tree), own)
    # The dict form carries the JAX package's leaves unchanged.
    np.testing.assert_array_equal(tree["triangles"]["verts"],
                                  np.asarray(jax_scene.triangles.verts))
    np.testing.assert_array_equal(tree["spheres"]["center"],
                                  np.asarray(jax_scene.spheres.center))


def test_scenes_equal_sees_a_changed_leaf():
    _, carried, own = _pair("cornell")
    light = dataclasses.replace(own.light, color=own.light.color * 2.0)
    assert not convert.scenes_equal(carried,
                                    dataclasses.replace(own, light=light))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compile_scene_matches_jax(name):
    jax_scene, carried, _ = _pair(name)
    ref = jint.compile_scene(jax_scene.triangles, lane_pad=1)
    got = tint.compile_scene(carried.triangles)
    assert got.num_triangles == NUM_TRIANGLES[name]
    # f32 constants built by the same formulas; 1e-6 relative covers the
    # ulp of a reciprocal square root and of fused vs unfused dot products.
    for field in ("n", "c0", "s1", "s2", "c1", "c2", "diffuse", "emissive"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=1e-6, atol=1e-6, err_msg=field)
    np.testing.assert_array_equal(got.is_emissive.numpy(),
                                  np.asarray(ref.is_emissive))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_potential_occluders_match_jax(name):
    jax_scene, carried, _ = _pair(name)
    jcfg = jtypes.RenderConfig(width=32, height=16)
    cfg = RenderConfig(width=32, height=16)
    ref = jint.potential_occluders(jax_scene, jcfg)
    got = tint.potential_occluders(carried, cfg)
    assert got == tuple(bool(x) for x in ref)
    # The box triangles stay, the walls and the light panel go.
    assert 0 < sum(got) < len(got)


def test_potential_occluders_disable_on_huge_scene():
    _, carried, _ = _pair("cornell")
    tri = dataclasses.replace(carried.triangles,
                              verts=carried.triangles.verts * 1000.0)
    with pytest.warns(UserWarning, match="disabling"):
        mask = tint.potential_occluders(
            dataclasses.replace(carried, triangles=tri))
    assert all(mask)


def test_render_config_fields_equal():
    ref = {f.name: f.default for f in dataclasses.fields(jtypes.RenderConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert got == ref
    cfg = RenderConfig(width=24, height=18)
    assert cfg.resolution == (24, 18) and cfg.num_pixels == 432
    assert cfg.replace(spp=4).spp == 4


def test_scene_to_moves_every_tensor():
    _, _, own = _pair("cornell-spheres")
    moved = own.to("cpu")
    assert all(t.device.type == "cpu" for t in moved.tensors())
    assert convert.scenes_equal(moved, own)
    assert port.__version__
