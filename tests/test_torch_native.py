"""PyTorch port: the native C++ host runtime (``native.py``) against the
port's pure-Python and PyTorch versions — tests/test_native.py's cases —
and its build: into the git-ignored build directory, safe when processes
build at once."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch import image as img
from gpuraytracer_tpu_torch import native
from gpuraytracer_tpu_torch import sampling as smp
from gpuraytracer_tpu_torch.intersect import compile_scene
from gpuraytracer_tpu_torch.scene import cornell_box

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    return native.load(strict=True)


def test_library_lives_in_the_build_directory(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert native.available()


def test_tonemap_matches_python(lib, rng):
    hdr = rng.random((17, 23, 3)).astype(np.float32) * 5.0
    got = native.tonemap(hdr, 2.0, 2.2)
    want = img.tonemap(hdr, 2.0, 2.2)
    # uint8 truncation: an ulp of powf may move a value across a step.
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(lib, rng, tmp_path, channels):
    rgb = (rng.random((31, 19, channels)) * 255).astype(np.uint8)
    native.write_png(str(tmp_path / "native.png"), rgb)
    np.testing.assert_array_equal(img.read_png(str(tmp_path / "native.png")),
                                  rgb)
    # image.write_png takes the native encoder; the pure-python one
    # decodes to the same pixels.
    img.write_png(str(tmp_path / "image.png"), rgb)
    img.write_png_python(str(tmp_path / "python.png"), rgb)
    assert (tmp_path / "image.png").read_bytes() == \
        (tmp_path / "native.png").read_bytes()
    np.testing.assert_array_equal(img.read_png(str(tmp_path / "python.png")),
                                  rgb)


def test_compile_triangles_matches_compile_scene(lib):
    tris = cornell_box(resolution=(64, 48)).triangles
    out11, c2 = native.compile_triangles(tris.verts.numpy())
    ref = compile_scene(tris)
    np.testing.assert_allclose(out11[:, 0:3], ref.n.numpy(), atol=1e-5)
    np.testing.assert_allclose(out11[:, 3], ref.c0.numpy(), atol=1e-5)
    np.testing.assert_allclose(out11[:, 4:7], ref.s1.numpy(), atol=1e-4)
    np.testing.assert_allclose(out11[:, 7], ref.c1.numpy(), atol=1e-4)
    np.testing.assert_allclose(out11[:, 8:11], ref.s2.numpy(), atol=1e-4)
    np.testing.assert_allclose(c2, ref.c2.numpy(), atol=1e-4)


@pytest.mark.parametrize("d", [0, 1, 5])
def test_halton_table_matches_sampling(lib, d):
    got = native.halton_table(7, 64, d)
    want = smp.halton(torch.arange(7, 71), d).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_row_means_matches_numpy(lib, rng):
    hdr = rng.random((9, 33, 3)).astype(np.float32)
    np.testing.assert_allclose(native.row_means(hdr), img.row_means(hdr),
                               rtol=1e-6)


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building into an empty directory at once: each
    compiles to a name of its own and renames it into place, so both load
    the library and no partial file is left."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from gpuraytracer_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        lib = native.load(strict=True)
        assert native.png_encode(__import__("numpy").zeros(
            (2, 2, 3), "uint8")).startswith(b"\\x89PNG")
        print(native.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(x.name for x in tmp_path.iterdir()) == sorted(names)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
    # Loading: None, remembered for the process; strict raises the error.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is None and not native.available()
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.load(strict=True)
