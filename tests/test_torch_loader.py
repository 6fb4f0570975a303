"""The port's BucketingLoader (khg_tpu_torch/data/loader.py): the cases
of tests/test_loader.py on the port's copy, and the same batches as
khg_tpu's loader for each seed and epoch."""

import numpy as np
import pytest

from khg_tpu.data import loader as j_loader
from khg_tpu_torch.data.loader import BucketingLoader, LoaderConfig


def make_dataset(rng, n=37, dim=8):
    lengths = rng.integers(20, 200, n)
    feats = [rng.standard_normal((int(t), dim)).astype(np.float32) for t in lengths]
    return feats, lengths


def test_loader_covers_all_utterances_once():
    feats, lengths = make_dataset(np.random.default_rng(0))
    loader = BucketingLoader(
        len(feats), lambda i: feats[i], lengths,
        LoaderConfig(batch_size=8, num_workers=2, prefetch=2),
    )
    seen = []
    for batch in loader.epoch(0):
        seen.extend(batch.indices.tolist())
        assert batch.feats.shape[0] == len(batch.indices)
        assert batch.feats.shape[1] % 32 == 0
        for j, i in enumerate(batch.indices):
            t = int(batch.num_frames[j])
            assert t == feats[i].shape[0]
            np.testing.assert_array_equal(batch.feats[j, :t], feats[i])
            assert np.all(batch.feats[j, t:] == 0)
    assert sorted(seen) == list(range(len(feats)))


def test_loader_bucketing_bounds_padding():
    feats, lengths = make_dataset(np.random.default_rng(1), n=64)
    loader = BucketingLoader(
        len(feats), lambda i: feats[i], lengths,
        LoaderConfig(batch_size=8, num_buckets=4, num_workers=0, shuffle=False),
    )
    waste = total = 0
    for batch in loader.epoch(0):
        waste += int(np.sum(batch.feats.shape[1] - batch.num_frames))
        total += int(np.sum(batch.num_frames))
    assert waste < 0.8 * total, (waste, total)


def test_loader_deterministic_per_seed():
    feats, lengths = make_dataset(np.random.default_rng(2), n=20)

    def mk():
        return BucketingLoader(
            len(feats), lambda i: feats[i], lengths,
            LoaderConfig(batch_size=4, num_workers=2), seed=7,
        )

    a = [b.indices.tolist() for b in mk().epoch(3)]
    assert a == [b.indices.tolist() for b in mk().epoch(3)]
    assert a != [b.indices.tolist() for b in mk().epoch(4)]


def test_loader_worker_error_propagates():
    def bad(i):
        if i == 3:
            raise ValueError("boom")
        return np.zeros((10, 4), dtype=np.float32)

    loader = BucketingLoader(6, bad, [10] * 6, LoaderConfig(batch_size=2, num_workers=2))
    with pytest.raises(ValueError, match="boom"):
        list(loader.epoch(0))


@pytest.mark.parametrize("seed,epoch,shuffle", [(0, 0, True), (7, 3, True),
                                                (7, 4, True), (1, 0, False)])
def test_loader_batches_equal_khg_tpu(seed, epoch, shuffle):
    feats, lengths = make_dataset(np.random.default_rng(3), n=41)
    kw = dict(batch_size=5, num_buckets=3, num_workers=2, shuffle=shuffle)
    ours = BucketingLoader(len(feats), lambda i: feats[i], lengths,
                           LoaderConfig(**kw), seed=seed)
    theirs = j_loader.BucketingLoader(len(feats), lambda i: feats[i], lengths,
                                      j_loader.LoaderConfig(**kw), seed=seed)
    a, b = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.indices, y.indices)
        np.testing.assert_array_equal(x.num_frames, y.num_frames)
        np.testing.assert_array_equal(x.feats, y.feats)
