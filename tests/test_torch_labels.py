"""The port's classifier training-set generator (`tools.labels`) against
the JAX package's (CPU)."""
import numpy as np
import torch

from aicp_mapping_tpu.tools import labels as jlabels
from aicp_mapping_tpu_torch.tools import labels

torch.set_num_threads(1)


def test_generate_labelled_pairs_matches_jax(tmp_path):
    """6 pairs (every third a corridor) from the same draws: the overlap
    within 1 %, the alignability within 1 of its 0-100 range, the labels
    JAX's; the label files written the same way."""
    got_f, got_l = labels.generate_labelled_pairs(6, seed=0, device="cpu")
    want_f, want_l = jlabels.generate_labelled_pairs(6, seed=0)
    np.testing.assert_allclose(got_f[:, 0], want_f[:, 0], rtol=0.01,
                               atol=0.01)
    np.testing.assert_allclose(got_f[:, 1], want_f[:, 1], atol=1.0)
    np.testing.assert_array_equal(got_l, want_l)
    a, b = tmp_path / "port.txt", tmp_path / "jax.txt"
    labels.write_label_file(str(a), got_f, got_l)
    jlabels.write_label_file(str(b), got_f, got_l)
    assert a.read_text() == b.read_text()
