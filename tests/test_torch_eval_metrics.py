"""The port's Objects / Boundary metrics against the JAX package's, exactly
(==, float for float), in both backends: seeded label pairs with many
labels, tied overlaps, label values that are not contiguous, the edge cases
of tests/test_evaluation.py, one 480x640 pair; aggregate_metrics,
print_metrics, save_result_mat; the pieces (disk, seg2bmap,
boundary_overlap) on their own."""

import numpy as np
import pytest
import scipy.io

from unseenobjectswithmeanshift_tpu.utils import evaluation as J
from unseenobjectswithmeanshift_torch.utils import evaluation as P
from torch_threads import few_torch_threads, module_tmp_cleanup  # noqa: F401

BACKENDS = ["native", "numpy"]


def label_pair(seed, h=48, w=64, ng=5, npred=6):
    """Rectangles of random ids on both sides (ids up to 40 on the
    prediction side, so labels skip values), overlapping each other."""
    r = np.random.RandomState(seed)
    gt = np.zeros((h, w), np.int32)
    pred = np.zeros((h, w), np.int32)
    for k in range(ng):
        y, x = r.randint(0, h - 6), r.randint(0, w - 6)
        gt[y:y + r.randint(3, h // 2), x:x + r.randint(3, w // 2)] = k + 1
    for _ in range(npred):
        y, x = r.randint(0, h - 6), r.randint(0, w - 6)
        pred[y:y + r.randint(3, h // 2), x:x + r.randint(3, w // 2)] = r.randint(1, 40)
    return pred, gt


def edge_pairs():
    gt = np.zeros((16, 16), np.int32)
    gt[2:6, 2:6] = 2
    empty = np.zeros_like(gt)
    tied_gt = np.zeros((16, 16), np.int32)        # two objects, each half covered twice
    tied_gt[0:8, 0:8], tied_gt[8:16, 8:16] = 1, 2
    tied = np.zeros_like(tied_gt)
    tied[0:8, 0:4], tied[0:8, 4:8], tied[8:16, 8:12], tied[8:16, 12:16] = 3, 4, 5, 6
    perfect = np.zeros((32, 32), np.int32)
    perfect[4:12, 4:12], perfect[20:28, 18:30] = 2, 3
    shifted = np.zeros_like(perfect)
    shifted[0:10, 1:11], shifted[21:31, 20:30] = 7, 5
    half = np.zeros_like(perfect)
    half[0:5, 0:10] = 2
    return [(empty, gt), (gt, empty), (empty, empty), (tied, tied_gt), (perfect, perfect),
            (shifted, perfect), (half, perfect)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_multilabel_metrics_equal_jax(backend):
    pairs = [label_pair(s, ng=1 + s % 6, npred=s % 8) for s in range(12)] + edge_pairs()
    for pred, gt in pairs:
        assert P.multilabel_metrics(pred, gt, backend=backend) == J.multilabel_metrics(pred, gt)


def test_full_width_pair_equal_jax_and_backends():
    pred, gt = label_pair(7, 480, 640, ng=10, npred=12)
    want = J.multilabel_metrics(pred, gt)
    assert P.multilabel_metrics(pred, gt, backend="native") == want
    assert P.multilabel_metrics(pred, gt, backend="numpy") == want
    labels_gt, labels_pred = np.unique(gt)[1:], np.unique(pred)[1:]
    a = P.pair_counts(pred, gt, labels_gt, labels_pred, backend="native")
    b = P.pair_counts(pred, gt, labels_gt, labels_pred, backend="numpy")
    assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pieces_equal_jax(backend):
    for r in (1, 2, 3, 5):
        assert np.array_equal(P.disk(r), J.disk(r))
    rng = np.random.RandomState(8)
    for _ in range(4):
        a, b = rng.rand(20, 27) > 0.6, rng.rand(20, 27) > 0.5
        assert np.array_equal(P.seg2bmap(a), J.seg2bmap(a))
        assert P.boundary_overlap(a, b, backend=backend) == J.boundary_overlap(a, b)
        assert P.boundary_overlap(a, b, 2, backend=backend) == J.boundary_overlap(a, b, 2)
    with pytest.raises(ValueError, match="backend"):
        P.multilabel_metrics(a, b, backend="cuda")


@pytest.mark.parametrize("backend", BACKENDS)
def test_any_label_values_equal_jax(backend):
    """Label values past 16 bits, negative values (objects too, as in the
    JAX metric), and ids far apart (the native maps' table over the ids'
    span, or past 2**20 values their sorted ids)."""
    pred, gt = label_pair(3, ng=5, npred=6)
    for offset, step in ((5000, 1000), (65535 - 8, 1), (-3, 7), (-2**31 + 1, 10**6),
                         (2**31 - 6 * 10**6, 10**6)):
        p = np.where(pred > 0, pred + offset, 0).astype(np.int32)
        g = np.where(gt > 0, gt * step + offset, 0).astype(np.int64)
        assert g.max() < 2**31 and g.min() >= -2**31
        g = g.astype(np.int32)
        with np.errstate(invalid="ignore"):          # no label clips to 1: 0 / 0 both sides
            got, want = P.multilabel_metrics(p, g, backend=backend), J.multilabel_metrics(p, g)
        np.testing.assert_equal(got, want)                 # exact, NaN equal to NaN


def test_aggregate_print_and_mat_equal_jax(tmp_path, capsys):
    metrics = [J.multilabel_metrics(*label_pair(s)) for s in range(5)]
    agg = P.aggregate_metrics(metrics)
    assert agg == J.aggregate_metrics(metrics)
    text = P.print_metrics(agg)
    assert text == J.print_metrics(agg)
    out = capsys.readouterr().out
    assert out.count(text) == 2
    pred, gt = label_pair(9)
    P.save_result_mat(str(tmp_path / "p.mat"), pred, gt, "ocid/000001")
    J.save_result_mat(str(tmp_path / "j.mat"), pred, gt, "ocid/000001")
    mp, mj = scipy.io.loadmat(str(tmp_path / "p.mat")), scipy.io.loadmat(str(tmp_path / "j.mat"))
    for k in ("labels", "labels_refined", "filename"):
        assert mp[k].dtype == mj[k].dtype and np.array_equal(mp[k], mj[k])
