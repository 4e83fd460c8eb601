"""intersector="auto": the routing table, and the compile-cache rule of the
entry points.

On the CPU backend `auto` resolves to the XLA BVH traversal (compiled
Pallas kernels do not run there), so the stock CLI render works with no
flags.
"""

import os

import numpy as np
import jax
import pytest

import akari_tpu.scene.nodes as nodes
from akari_tpu.integrators.path import PathConfig, render
from akari_tpu.scene.builtin import cornell_box
from akari_tpu.scene.nodes import (
    DENSE_MAX_TRIS,
    GPU_DENSE_INTERSECTOR,
    _auto_intersector,
)
from akari_tpu.utils import compile_cache


def test_auto_resolves_to_bvh_on_cpu():
    assert jax.default_backend() == "cpu"  # conftest forces CPU
    assert _auto_intersector(36) == "bvh"
    assert _auto_intersector(DENSE_MAX_TRIS + 1) == "bvh"


def test_auto_routing_table_on_gpu(monkeypatch):
    """GPU: the measured dense winner up to DENSE_MAX_TRIS, the XLA BVH
    walk above it; no size is refused."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert GPU_DENSE_INTERSECTOR in ("pallas", "brute")
    assert _auto_intersector(36) == GPU_DENSE_INTERSECTOR
    assert _auto_intersector(DENSE_MAX_TRIS) == GPU_DENSE_INTERSECTOR
    assert _auto_intersector(DENSE_MAX_TRIS + 1) == "bvh"
    assert _auto_intersector(50_000_000) == "bvh"
    sc = cornell_box(8, 8).compile(intersector="auto")
    assert sc.intersector == GPU_DENSE_INTERSECTOR


def test_auto_rejects_unknown_platform(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="no intersector route"):
        _auto_intersector(36)


def test_auto_routes_instanced_scenes(monkeypatch):
    """Instanced scenes: flattened for the dense route while the world
    total is at most DENSE_MAX_TRIS, two-level BVH above it (GPU) and
    always two-level on the CPU."""
    mesh = cornell_box(8, 8).shapes[0]
    n = len(np.asarray(mesh.indices))
    eye = np.eye(4, dtype=np.float32)
    few = [nodes.Instance(mesh, eye) for _ in range(2)]
    many = [nodes.Instance(mesh, eye)
            for _ in range(DENSE_MAX_TRIS // n + 1)]
    assert nodes.compile_scene(few, intersector="auto").instances is not None
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    small = nodes.compile_scene(few, intersector="auto")
    assert small.instances is None
    assert small.intersector == GPU_DENSE_INTERSECTOR
    big = nodes.compile_scene(many, intersector="auto")
    assert big.instances is not None and big.intersector == "bvh"


def test_auto_scene_renders_on_cpu():
    sc = cornell_box(16, 16)
    scene = sc.compile(intersector="auto")
    assert scene.intersector == "bvh"
    img = np.asarray(render(scene, sc.camera, PathConfig(spp=1, max_depth=2)))
    assert np.isfinite(img).all() and img.mean() > 0.01


def test_stock_cli_render_works_on_cpu(tmp_path):
    """The flagship CLI with NO intersector flag must not crash on CPU
    (it once crashed with 'Only interpret mode is supported on CPU
    backend')."""
    import subprocess
    import sys

    out = str(tmp_path / "out.png")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "akari_tpu.cli.render",
         "-i", "scenes/cornell_box/scene.akari", "-o", out,
         "--spp", "1", "--max-depth", "2", "--width", "32", "--height", "32"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.join(os.path.dirname(__file__), ".."), env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_compile_cache_follows_environment_variable():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache"}
    assert compile_cache.compile_cache_dir(env) == "/some/cache"


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without the variable: a fixed `.jax_cache/` at the checkout root
    (no temp name, PID or time in the path), git-ignored."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.compile_cache_dir({})
    assert path == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    assert compile_cache.enable_compile_cache() == path
    assert seen == {"jax_compilation_cache_dir": path}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    seen.clear()
    assert compile_cache.enable_compile_cache() == "/elsewhere"
    assert seen == {}
