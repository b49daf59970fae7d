"""The port's risk-classifier training (`RiskClassifier.train`) and the
`classifier` CLI against the JAX package's (CPU).

The descent is sensitive to rounding: a hinge kink crossed one step apart
parts two runs for good. The port and JAX agree to ~1e-6 while no kink
separates them (a few hundred steps on the synthetic set), and at the
default 4,000 steps by as much as JAX agrees with itself when its inputs
move by one ulp (0.2-1.7 % in probability on the shipped label sets)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aicp_mapping_tpu import cli as jcli
from aicp_mapping_tpu.classification import RiskClassifier as JClf
from aicp_mapping_tpu.classification import classifier as jclassifier
from aicp_mapping_tpu_torch import cli
from aicp_mapping_tpu_torch.classification import RiskClassifier
from aicp_mapping_tpu_torch.classification import classifier
from aicp_mapping_tpu_torch.classification import load_label_file

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..", "data", "labels")
SETS = {"synthetic": ("training_synthetic.txt", "testing_synthetic.txt"),
        "real": ("training_all_labelled_1Sep.txt",
                 "testing_labelled_27Aug.txt")}
# probabilities of the default 4,000-step model against JAX's: JAX's own
# one-ulp spread (above) with room
TOL_PROB = 0.03


def _standardized(features):
    """JAX's standardization of the training features, as numpy."""
    f = jnp.asarray(features, jnp.float32)
    mean = jnp.mean(f, axis=0)
    std = jnp.maximum(jnp.std(f, axis=0), 1e-6)
    return np.array((f - mean) / std)


def _jax_loss(params, phi, s, sw, l2=1e-3):
    """The loss JAX's `_train` differentiates."""
    w, b = params
    f = phi @ w + b
    return jnp.mean(sw * jnp.maximum(0.0, 1.0 - s * f)) + l2 * jnp.sum(w * w)


@pytest.mark.parametrize("b", [1.0, -1.0, 0.5])
def test_hinge_gradient_takes_jax_tie_rule(b):
    """At b = +-1, w = 0 every sample of one class sits on its hinge
    (1 - s f == 0): `jax.grad` gives those samples slope 1/2, and so does
    the port."""
    feats, labels = load_label_file(os.path.join(ROOT, SETS["synthetic"][0]))
    phi = np.array(jclassifier.poly3_features(
        jnp.asarray(_standardized(feats))))
    y = labels.astype(np.float32)
    s = 2.0 * y - 1.0
    n = len(y)
    pos, neg = max(y.sum(), 1.0), max(n - y.sum(), 1.0)
    sw = np.where(y > 0.5, n / (2 * pos), n / (2 * neg)).astype(np.float32)
    w = np.zeros(10, np.float32)
    gw, gb = jax.grad(_jax_loss)((jnp.asarray(w), jnp.float32(b)),
                                 jnp.asarray(phi), jnp.asarray(s),
                                 jnp.asarray(sw))
    t = [torch.as_tensor(a) for a in (phi, s, sw / np.float32(n), w)]
    pw, pb = classifier.hinge_gradient(t[0], t[1], t[2], t[3],
                                       torch.tensor(b), 1e-3)
    np.testing.assert_allclose(pw.numpy(), np.asarray(gw), rtol=1e-6,
                               atol=1e-7)
    assert float(pb) == pytest.approx(float(gb), rel=1e-6, abs=1e-7)
    if abs(b) == 1.0:    # ties present: a slope of 1 or 0 would differ
        ties = (1.0 - s * b) == 0
        assert ties.any()
        full = np.float32(-(sw / n * s)[ties].sum())
        assert abs(float(pb) - (float(gb) - 0.5 * full)) > 1e-3


@pytest.mark.parametrize("steps", [1, 10, 100, 300])
def test_train_steps_match_jax(steps):
    """While no kink separates the runs, w and b agree to rtol 1e-3 and the
    probabilities to 1e-4."""
    feats, labels = load_label_file(os.path.join(ROOT, SETS["synthetic"][0]))
    z = _standardized(feats)
    wj, bj = jclassifier._train(jnp.asarray(z), jnp.asarray(labels),
                                steps=steps)
    wp, bp = classifier._train(torch.as_tensor(z), torch.as_tensor(labels),
                               steps=steps)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-3,
                               atol=1e-6)
    assert float(bp) == pytest.approx(float(bj), rel=1e-3, abs=1e-6)
    phi = np.array(jclassifier.poly3_features(jnp.asarray(z)), np.float64)

    def prob(w, b):
        return 1.0 / (1.0 + np.exp(-(phi @ np.asarray(w) + float(b))))

    np.testing.assert_allclose(prob(wp.numpy(), bp), prob(wj, bj),
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(SETS))
def test_train_matches_jax(name):
    """The default 4,000-step model: the same confusion counts on the test
    set, probabilities within TOL_PROB, the standardization JAX's."""
    train, test = (os.path.join(ROOT, f) for f in SETS[name])
    ftr, ltr = load_label_file(train)
    fte, lte = load_label_file(test)
    got, want = RiskClassifier(device="cpu"), JClf()
    got.train(ftr, ltr)
    want.train(ftr, ltr)
    np.testing.assert_allclose(got.model.mean.numpy(),
                               np.asarray(want.model.mean), rtol=1e-6)
    np.testing.assert_allclose(got.model.std.numpy(),
                               np.asarray(want.model.std), rtol=1e-6)
    pg, sg = got.test(fte, lte)
    pw, sw = want.test(fte, lte)
    assert sg == sw
    np.testing.assert_allclose(pg.numpy(), np.asarray(pw).reshape(-1),
                               atol=TOL_PROB)


def test_jax_classifier_tests_hold_on_the_port(tmp_path):
    """tests/test_classifier.py's separation and save/load round trip."""
    rng = np.random.default_rng(0)
    overlap, align = rng.uniform(0, 100, 400), rng.uniform(0, 30, 400)
    y = (overlap / 100.0 + align / 30.0 < 0.8).astype(np.float32)
    x = np.stack([overlap, align], axis=1).astype(np.float32)
    clf = RiskClassifier(threshold=0.5, device="cpu")
    clf.train(x, y, steps=2000)
    _, stats = clf.test(x, y)
    assert stats["accuracy"] > 0.95, stats
    assert float(clf.test(np.array([[5.0, 1.0]]))) > 0.8
    assert float(clf.test(np.array([[90.0, 25.0]]))) < 0.2
    path = str(tmp_path / "svm_model.npz")
    clf.save(path)
    back = RiskClassifier()
    back.load(path)
    torch.testing.assert_close(back.test(x[:10]), clf.test(x[:10]))
    jback = JClf()
    jback.load(path)          # the JAX package loads the port's model
    np.testing.assert_allclose(np.asarray(jback.test(x[:10])).reshape(-1),
                               clf.test(x[:10]).numpy(), atol=1e-6)


def test_train_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RiskClassifier().train(np.zeros((4, 2)), np.array([0, 1, 0, 1]))


def test_cli_classifier_matches_jax(tmp_path, capsys):
    train, test = (os.path.join(ROOT, f) for f in SETS["synthetic"])
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        model = str(tmp_path / f"{name}.npz")
        argv = ["classifier", "--train", train, "--test", test, "--model",
                model, "--save-probs", str(tmp_path / f"{name}.txt"),
                "--save-eval", str(tmp_path / f"{name}.json")] + extra
        assert main(argv) == 0
        out[name] = json.loads(capsys.readouterr().out)
        # a saved model tests again through --model
        assert main(["classifier", "--model", model, "--test", test]
                    + extra) == 0
        assert json.loads(capsys.readouterr().out) == out[name]
    got, want = out["port"], out["jax"]
    assert got.keys() == want.keys()
    for k in ("tp", "tn", "fp", "fn", "accuracy", "precision", "recall",
              "f1"):
        assert got[k] == want[k], k
    assert abs(got["auc"] - want["auc"]) <= 0.01
    assert abs(got["best_f1"] - want["best_f1"]) <= 0.05
    np.testing.assert_allclose(np.loadtxt(str(tmp_path / "port.txt")),
                               np.loadtxt(str(tmp_path / "jax.txt")),
                               atol=TOL_PROB)
    saved = json.load(open(tmp_path / "port.json"))
    assert saved["test"] == test and saved["tp"] == got["tp"]
    assert cli.main(["classifier", "--test", test]) == 2
