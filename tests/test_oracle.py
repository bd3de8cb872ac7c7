"""Self-checks for the float64 oracle (the FCL stand-in) — it must be right
before it can arbitrate. Anchored on the golden datasets: the oracle's
verdicts must reproduce FCL's tags."""
import numpy as np
import pytest

from robocheck.oracle import cpu_oracle as oc


def test_tri_tri_basic():
    a = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float64)
    # Crossing the z=0 plane through the middle of `a`.
    b = np.array([[0.5, 0.5, -1], [0.5, 0.5, 1], [1.5, 0.5, 1]], np.float64)
    assert oc.tri_tri_intersect(a, b)
    # Far away.
    c = b + np.array([10, 10, 10])
    assert not oc.tri_tri_intersect(a, c)


def test_tri_tri_coplanar():
    a = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float64)
    b = np.array([[1, 1, 0], [3, 1, 0], [1, 3, 0]], np.float64)  # overlaps in-plane
    assert oc.tri_tri_intersect(a, b)
    c = np.array([[10, 10, 0], [12, 10, 0], [10, 12, 0]], np.float64)
    assert not oc.tri_tri_intersect(a, c)


def test_tri_tri_coplanar_containment():
    big = np.array([[-5, -5, 1], [5, -5, 1], [0, 5, 1]], np.float64)
    small = np.array([[-0.1, -0.1, 1], [0.1, -0.1, 1], [0, 0.1, 1]], np.float64)
    assert oc.tri_tri_intersect(big, small)
    assert oc.tri_tri_intersect(small, big)


def test_shared_edge_meshes_do_intersect():
    a = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    b = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float64)  # shares an edge
    assert oc.tri_tri_intersect(a, b)


@pytest.mark.parametrize("dataset,n", [("hard10k", 96), ("easy10k", 96)])
def test_oracle_matches_goldens(request, dataset, n):
    ds = request.getfixturevalue(dataset)
    robot, obstacle = request.getfixturevalue("alpha_meshes")
    pred = oc.check_configs(robot, obstacle, ds.confs[:n])
    np.testing.assert_array_equal(pred, ds.valid[:n])
