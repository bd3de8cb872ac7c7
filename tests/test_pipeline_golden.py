"""Tier-4 differential tests: full pipeline vs the FCL-tagged golden datasets
(the reference's acceptance criterion — exact verdict equality with FP/FN
triage, `test/full-integration-test.cu:695-724`)."""
import numpy as np
import pytest

from robocheck.ops.pipeline import CollisionWorld, PipelineConfig


@pytest.fixture(scope="module")
def world(alpha_meshes):
    robot, obstacle = alpha_meshes
    return CollisionWorld(
        robot, obstacle,
        PipelineConfig(batch_block=64, narrow_chunk=8, max_pairs=8192),
    )


@pytest.fixture(scope="module")
def big_world(alpha_meshes):
    # Larger blocks amortize dispatch for the full-file runs (~45 s/10k file
    # on a 2-core CPU vs ~90 s at batch_block=64).
    robot, obstacle = alpha_meshes
    return CollisionWorld(
        robot, obstacle,
        PipelineConfig(batch_block=256, narrow_chunk=8, max_pairs=16384),
    )


def _diff_report(pred, gold):
    fp = int(np.sum(pred & ~gold))  # predicted valid, actually colliding
    fn = int(np.sum(~pred & gold))  # predicted colliding, actually valid
    return fp, fn


def test_hard10k_slice(world, hard10k):
    n = 256
    pred = world.check(hard10k.confs[:n])
    gold = hard10k.valid[:n]
    fp, fn = _diff_report(pred, gold)
    assert fp == 0 and fn == 0, f"false-positives={fp} false-negatives={fn}"


def test_easy10k_slice(world, easy10k):
    n = 256
    pred = world.check(easy10k.confs[:n])
    gold = easy10k.valid[:n]
    fp, fn = _diff_report(pred, gold)
    assert fp == 0 and fn == 0, f"false-positives={fp} false-negatives={fn}"


def test_easy_has_invalid_configs(world, easy10k):
    # The 3 colliding configs of easy10k are the interesting ones; find and
    # check a window around the first of them.
    idx = np.nonzero(~easy10k.valid)[0]
    assert idx.size == 3  # dataset header: 9997 valid / 3 invalid
    lo = (int(idx[0]) // 64) * 64
    window = slice(lo, lo + 64)
    pred = world.check(easy10k.confs[window])
    np.testing.assert_array_equal(pred, easy10k.valid[window])


def test_stats_surface(world, hard10k):
    valid, res = world.check(hard10k.confs[:64], return_result=True)
    assert res.num_pairs.shape == (64,)
    # Hard configs sit inside the obstacle AABB — almost all reach narrow.
    assert (~res.broad_valid).sum() > 32
    assert not res.overflow.any()


def test_samples10k_file_is_untagged(samples10k):
    # The reference shipped 10,000samples.conf with an FCL header count
    # (7296 valid / 2704 invalid) but never wrote the verdicts back to the
    # rows — every tag is 0. Document the fact so nobody "fixes" a verdict
    # diff against these tags. (The checkers reproduce the header's 7296
    # exactly.)
    assert (samples10k.header_valid, samples10k.header_invalid) == (7296, 2704)
    assert samples10k.num_valid == 0
    assert samples10k.tags_match_header is False


def test_samples10k_slice_vs_oracle(world, samples10k):
    # Row tags are unusable (above); the float64 oracle is the ground truth
    # for this dataset. Differential check on a slice.
    from robocheck.oracle import check_configs

    n = 64
    confs = samples10k.confs[:n]
    pred = world.check(confs)
    gold = check_configs(world.robot, world.obstacle, confs)
    fp, fn = _diff_report(pred, gold)
    assert fp == 0 and fn == 0, f"false-positives={fp} false-negatives={fn}"


# The full 20k tagged verdicts run in DEFAULT CI (not slow-marked): a bug
# that only manifests past configuration #256 must not survive a CPU-only
# merge gate. (~90 s for both files on a 2-core CPU.)
def test_hard10k_full(big_world, hard10k):
    pred = big_world.check(hard10k.confs)
    fp, fn = _diff_report(pred, hard10k.valid)
    assert fp == 0 and fn == 0, f"false-positives={fp} false-negatives={fn}"


def test_easy10k_full(big_world, easy10k):
    pred = big_world.check(easy10k.confs)
    fp, fn = _diff_report(pred, easy10k.valid)
    assert fp == 0 and fn == 0, f"false-positives={fp} false-negatives={fn}"
