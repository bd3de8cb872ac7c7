"""IO round-trip tests (.obj / .conf formats, `Utils_rai.cu:11-320`)."""
import numpy as np

from robocheck.core.types import Mesh
from robocheck.io.conf import read_conf_file, write_conf_file
from robocheck.io.obj import load_obj, save_obj


def test_obj_roundtrip(tmp_path):
    mesh = Mesh(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
        triangles=np.array([[0, 1, 2], [0, 1, 3]], np.int32),
        name="tetra",
    )
    p = tmp_path / "m.obj"
    save_obj(mesh, p)
    back = load_obj(p)
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-6)
    np.testing.assert_array_equal(back.triangles, mesh.triangles)


def test_obj_polygon_fan(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    mesh = load_obj(p)
    assert mesh.num_triangles == 2
    np.testing.assert_array_equal(mesh.triangles, [[0, 1, 2], [0, 2, 3]])


def test_obj_slash_indices(tmp_path):
    p = tmp_path / "s.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvt 0 0\nf 1/1/1 2/1/1 3/1/1\n"
    )
    mesh = load_obj(p)
    assert mesh.num_triangles == 1
    np.testing.assert_array_equal(mesh.triangles, [[0, 1, 2]])


def test_conf_roundtrip(tmp_path, rng):
    confs = rng.normal(size=(10, 6)).astype(np.float32)
    valid = rng.random(10) > 0.5
    p = tmp_path / "t.conf"
    write_conf_file(p, confs, valid)
    header = p.read_text().splitlines()[0]
    assert f"There are {valid.sum()} valid" in header
    back = read_conf_file(p)
    np.testing.assert_allclose(back.confs, confs, rtol=1e-5)
    np.testing.assert_array_equal(back.valid, valid)


def test_reads_reference_format(tmp_path):
    p = tmp_path / "ref.conf"
    p.write_text(
        "There are 1 valid configurations and 1 invalid configurations\n"
        "-34.0693 90.0871 160.669 1.17943 -1.62322 1.34003 1\n"
        "1.5 2.5 3.5 0.1 0.2 0.3 0\n"
    )
    ds = read_conf_file(p)
    assert ds.confs.shape == (2, 6)
    assert ds.valid.tolist() == [True, False]
    np.testing.assert_allclose(ds.confs[0, 0], -34.0693, rtol=1e-5)


def test_header_counts_parsed(tmp_path):
    p = tmp_path / "h.conf"
    p.write_text(
        "There are 2 valid configurations and 1 invalid configurations\n"
        "0 0 0 0 0 0 1\n"
        "1 1 1 0 0 0 1\n"
        "2 2 2 0 0 0 0\n"
    )
    ds = read_conf_file(p)
    assert (ds.header_valid, ds.header_invalid) == (2, 1)
    assert ds.tags_match_header is True


def test_header_tag_mismatch_detected(tmp_path):
    # The reference's own 10,000samples.conf: header claims 7296 valid but
    # every row tag is 0 (the FCL verdicts were never written back). The
    # reader must surface the inconsistency, not silently trust either side.
    p = tmp_path / "stale.conf"
    p.write_text(
        "There are 2 valid configurations and 0 invalid configurations\n"
        "0 0 0 0 0 0 0\n"
        "1 1 1 0 0 0 0\n"
    )
    ds = read_conf_file(p)
    assert ds.header_valid == 2 and ds.num_valid == 0
    assert ds.tags_match_header is False


def test_header_invalid_count_mismatch_detected(tmp_path):
    # A truncated file can keep the right valid count while losing invalid
    # rows; the invalid count must be checked too.
    p = tmp_path / "trunc.conf"
    p.write_text(
        "There are 1 valid configurations and 2 invalid configurations\n"
        "0 0 0 0 0 0 1\n"
        "1 1 1 0 0 0 0\n"
    )
    ds = read_conf_file(p)
    assert ds.num_valid == ds.header_valid == 1
    assert ds.tags_match_header is False


def test_headerless_file_has_no_header_counts(tmp_path):
    p = tmp_path / "nh.conf"
    p.write_text("0 0 0 0 0 0\n1 1 1 0 0 0\n")
    ds = read_conf_file(p)
    assert ds.valid is None
    assert ds.header_valid is None
    assert ds.tags_match_header is None


def test_alpha_assets_load(alpha_meshes):
    robot, obstacle = alpha_meshes
    # Reference capacities: Utils_rai.h:98-99.
    assert robot.num_vertices == 792
    assert robot.num_triangles == 1008
    assert obstacle.num_vertices == 792
    assert obstacle.num_triangles == 1008
    padded = robot.padded()
    assert padded.triangles.shape[0] == 1024
    assert padded.tri_mask.sum() == 1008
