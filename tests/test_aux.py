"""Auxiliary subsystem tests: Parasol formats, BYU loader, profiling
counters, checkpointing."""
import numpy as np
import pytest

from robocheck.io import assets
from robocheck.io.byu import byu_to_obj, load_byu
from robocheck.io.obj import load_obj
from robocheck.io.parasol import read_env, read_query
from robocheck.profiling.counters import CheckStats, verdict_diff
from robocheck.profiling.timers import StageTimer, benchmark
from robocheck.runtime import checkpoint


class TestParasol:
    def test_alpha_query(self):
        try:
            path = assets.find_asset("models/alpha1.0/alpha.query")
        except FileNotFoundError:
            pytest.skip("alpha assets not fetched")
        q = read_query(path)
        assert q.shape == (2, 6)
        # First line: "0 78.240253 24.147785 -8.133371 ..."
        np.testing.assert_allclose(q[0, :3], [78.240253, 24.147785, -8.133371],
                                   rtol=1e-6)
        # Rotations are fractions of a turn -> radians within [0, 2pi].
        assert (np.abs(q[:, 3:]) <= 2 * np.pi + 1e-5).all()

    def test_alpha_env(self):
        try:
            path = assets.find_asset("models/alpha1.0/alpha.env")
        except FileNotFoundError:
            pytest.skip("alpha assets not fetched")
        env = read_env(path)
        np.testing.assert_array_equal(env.boundary,
                                      [-200, -200, -200, 200, 200, 200])
        assert env.active_meshes == ("robot.obj",)
        assert env.passive_meshes == ("obstacle.obj",)


class TestBYU:
    def test_roundtrip_synthetic(self, tmp_path):
        # Two triangles; polygon list terminates each line with a negated
        # 1-based index.
        g = tmp_path / "m.g"
        g.write_text(
            "1 4 2 6\n1 2\n"
            "0 0 0\n1 0 0\n0 1 0\n0 0 1\n"
            "1 2 -3\n1 3 -4\n"
        )
        mesh = load_byu(g)
        assert mesh.num_vertices == 4
        assert mesh.num_triangles == 2
        np.testing.assert_array_equal(mesh.triangles, [[0, 1, 2], [0, 2, 3]])

    def test_quad_fan(self, tmp_path):
        g = tmp_path / "q.g"
        g.write_text(
            "1 4 1 4\n1 1\n"
            "0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
            "1 2 3 -4\n"
        )
        mesh = load_byu(g)
        assert mesh.num_triangles == 2

    def test_byu_to_obj(self, tmp_path):
        g = tmp_path / "m.g"
        g.write_text("1 3 1 3\n1 1\n0 0 0\n1 0 0\n0 1 0\n1 2 -3\n")
        out = tmp_path / "m.obj"
        byu_to_obj(g, out)
        back = load_obj(out)
        assert back.num_triangles == 1


class TestCounters:
    def test_stats(self):
        valid = np.array([1, 1, 0, 1], bool)
        cop = np.zeros(4, bool)
        pairs = np.array([0, 5, 100, 0])
        broad = np.array([0, 1, 1, 0], bool)
        s = CheckStats.from_check(valid, cop, pairs, broad, 0.5)
        assert s.num_valid == 3
        assert s.broad_culled == 2
        assert s.checks_per_s == 8.0
        assert s.mean_pairs_surviving == 52.5
        assert "4 confs" in s.report()

    def test_verdict_diff(self):
        pred = np.array([1, 0, 1, 1], bool)
        gold = np.array([1, 1, 0, 1], bool)
        d = verdict_diff(pred, gold)
        assert d["mismatches"] == 2
        assert d["false_positives"] == 1  # index 2: predicted valid, colliding
        assert d["false_negatives"] == 1
        assert d["fp_indices"] == [2]


class TestTimers:
    def test_stage_timer(self):
        t = StageTimer()
        with t.stage("a"):
            sum(range(1000))
        with t.stage("a"):
            pass
        assert t.counts["a"] == 2
        assert "a:" in t.report()

    def test_benchmark(self):
        calls = []
        best = benchmark(lambda: calls.append(1), runs=3, warmup=1)
        assert best >= 0
        assert len(calls) == 4


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        p = tmp_path / "state.npz"
        arrays = {"traj": np.arange(12.0).reshape(2, 6)}
        checkpoint.save(p, arrays, meta={"round": 3})
        assert checkpoint.exists(p)
        back, meta = checkpoint.load(p)
        np.testing.assert_array_equal(back["traj"], arrays["traj"])
        assert meta == {"round": 3}


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    # JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    # the cache lives at a fixed path inside the checkout.
    import os

    import jax

    from robocheck.runtime import cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache._DEFAULT_DIR == os.path.join(repo, ".jax_cache")
        # Enable it on a stand-in path, keeping the checkout clean.
        monkeypatch.setattr(cache, "_DEFAULT_DIR", str(tmp_path / "c"))
        try:
            assert cache.enable_compilation_cache() == str(tmp_path / "c")
            assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        assert cache.enable_compilation_cache() == str(tmp_path / "e")
        assert jax.config.jax_compilation_cache_dir == before
