"""planner/knn.py — scalable NN under the weighted wrapped metric.

The chord KD-tree must agree with brute force on the planners' exact
metric (including angle wrap-around, where naive Euclidean KD-trees are
wrong), and must actually scale to the roadmap sizes the north star needs.
"""
import time

import numpy as np

from robocheck.planner.knn import (
    IncrementalNearest,
    conf_distance,
    conf_knn,
)

ROT = 20.0


def _brute_knn(verts, k):
    d = conf_distance(verts[:, None, :].astype(np.float64),
                      verts[None, :, :].astype(np.float64), ROT)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1)[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


def _random_confs(rng, n, span=5.0):
    c = np.empty((n, 6), np.float32)
    c[:, 0:3] = rng.uniform(-span, span, (n, 3))
    c[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
    return c


def test_knn_matches_brute_force():
    rng = np.random.default_rng(11)
    verts = _random_confs(rng, 400)
    # Wrap stress: cluster pairs across the +/-pi seam.
    verts[:50, 3] = np.pi - 0.01
    verts[50:100, 3] = -np.pi + 0.01
    nbrs, dists = conf_knn(verts, 8, ROT)
    bn, bd = _brute_knn(verts, 8)
    # Distances must match exactly where the neighbor sets agree, and the
    # distance PROFILE must match everywhere (chord candidates + exact
    # rerank can only differ on far ties at the candidate horizon).
    np.testing.assert_allclose(dists, bd, rtol=1e-9, atol=1e-12)


def test_incremental_nearest_exact():
    rng = np.random.default_rng(5)
    nn = IncrementalNearest(ROT)
    all_nodes = []
    for batch in range(6):
        pts = _random_confs(rng, 100 + 37 * batch)
        all_nodes.append(pts)
        nn.add(pts)
        q = _random_confs(rng, 64)
        gi, gd = nn.nearest(q)
        nodes = np.concatenate(all_nodes)
        d = conf_distance(nodes[None, :, :].astype(np.float64),
                          q[:, None, :].astype(np.float64), ROT)
        bi = np.argmin(d, axis=1)
        bd = d[np.arange(len(q)), bi]
        np.testing.assert_allclose(gd, bd, rtol=1e-9, atol=1e-12)


def test_incremental_nearest_chord_gap_regression():
    # Regression for the exactness-fallback direction: chord is a LOWER
    # bound on exact distance, so the dense fallback must trigger whenever
    # the last fetched candidate's chord distance is below the best exact
    # distance. Construction: 20 rotation-only nodes at exact distance 0.9
    # (chord 2*sin(0.45) ~= 0.870) crowd out the k_cand=8 candidate list,
    # while one translation-only node at exact distance 0.88 (chord 0.88)
    # is never fetched. An earlier version scaled the bound by pi/2 and
    # returned the 0.9 node.
    nn = IncrementalNearest(rot_scale=1.0)
    nodes = np.zeros((21, 6), np.float32)
    nodes[:20, 3] = 0.9  # rotation-only
    nodes[20, 0] = 0.88  # translation-only: the true nearest
    nn.add(nodes)
    # Force everything into the tree (no dense tail).
    assert nn._tree_n == 21
    q = np.zeros((1, 6), np.float32)
    gi, gd = nn.nearest(q)
    assert gi[0] == 20
    np.testing.assert_allclose(gd[0], 0.88, rtol=1e-6)


def test_knn_chord_gap_rescan_makes_exact():
    # conf_knn twin of the IncrementalNearest regression: rotation-only
    # nodes (chord 2*sin(0.45) ~= 0.870 < exact 0.9) crowd the oversampled
    # chord candidate list of the origin row, while the true nearest — a
    # translation-only node at 0.88 (chord == exact) — is never fetched.
    # The per-row horizon check must trigger the dense rescan.
    nodes = np.zeros((12, 6), np.float32)
    nodes[1:11, 3] = 0.9  # rotation-only crowd
    nodes[11, 0] = 0.88  # translation-only: the true nearest to row 0
    nbrs, dists = conf_knn(nodes, 1, 1.0, oversample=3)
    assert nbrs[0, 0] == 11
    np.testing.assert_allclose(dists[0, 0], 0.88, rtol=1e-6)
    # Full-row agreement with brute force under rot_scale=1.
    d = conf_distance(nodes[:, None, :].astype(np.float64),
                      nodes[None, :, :].astype(np.float64), 1.0)
    np.fill_diagonal(d, np.inf)
    np.testing.assert_allclose(
        dists[:, 0], d.min(axis=1), rtol=1e-9, atol=1e-12)


def test_knn_scales_to_roadmap_sizes():
    # The round-3 dense sweep was ~10^10 distance evals at 100k samples;
    # the KD path must do 50k in seconds (loose wall-clock bound so slow
    # CI doesn't flake).
    rng = np.random.default_rng(2)
    verts = _random_confs(rng, 50_000)
    t0 = time.perf_counter()
    nbrs, dists = conf_knn(verts, 12, ROT)
    dt = time.perf_counter() - t0
    assert nbrs.shape == (50_000, 12)
    assert np.isfinite(dists).all()
    assert dt < 60.0
