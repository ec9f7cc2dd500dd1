"""The mesh featurize of the Fisher-vector workloads and the naive-Bayes mesh
scoring (``keystone_tpu_torch.workloads.fv_common``, ``voc_sift_fisher``,
``imagenet_sift_lcs_fv``, ``newsgroups``, ``solvers.naive_bayes``) against
the port's unsharded runs and the JAX package's mesh runs
(``tests/test_workloads_mesh.py``).

A mesh here is slots of the one CPU; the JAX side runs on the conftest's 8
virtual CPU devices.  Bars: descriptors, features and naive-Bayes scores
are held bit for bit (every featurize and score is row-wise and
batch-invariant); fitted scores of a mesh with a data axis within rtol
1e-4, atol 1e-5·max of the unsharded run (the solves add their row sums
over the data axis in data order), and bit for bit on meshes without one;
VOC's APs within 1e-6 and ImageNet's top-1/top-5 equal.  The cases that
need a JAX mesh run of VOC or ImageNet are marked ``slow``, as their JAX
twins are."""

import contextlib

import numpy as np
import pytest
import torch

from keystone_tpu.loaders.image_loaders import imagenet_loader as jax_imagenet_loader
from keystone_tpu.loaders.image_loaders import voc_loader as jax_voc_loader
from keystone_tpu.loaders.newsgroups import newsgroups_loader as jax_ng_loader
from keystone_tpu.workloads import imagenet_sift_lcs_fv as jax_inet
from keystone_tpu.workloads import newsgroups as jax_ng
from keystone_tpu.workloads import voc_sift_fisher as jax_voc
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.loaders.newsgroups import newsgroups_loader
from keystone_tpu_torch.ops import fisher as pfisher
from keystone_tpu_torch.ops.sparse import CSRFeatures
from keystone_tpu_torch.parallel import mesh as pmesh
from keystone_tpu_torch.parallel.mesh import ShardedRows, make_mesh, use_mesh
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.solvers.naive_bayes import NaiveBayesModel
from keystone_tpu_torch.workloads import fv_common as pfv
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as pinet
from keystone_tpu_torch.workloads import newsgroups as png
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from test_fisher_pipelines import write_voc_tar
from test_torch_imagenet import NUM_CLASSES, SMALL_CONF, _write_split
from test_torch_imagenet import SMALL as INET_FLAGS
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

CPU = torch.device("cpu")
MESHES = {"4x2": (4, 2), "8x1": (8, 1), "1x8": (1, 8)}
VOC_CONF = dict(lam=0.05, desc_dim=16, vocab_size=8, num_pca_samples=6000,
                num_gmm_samples=6000, sift_step_size=6)


def _mesh(data, model, devices=None):
    return make_mesh(data, model, devices=devices or [CPU] * (data * model))


def _close(got, want):
    bar = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=bar)


# -- the featurize on the slots --------------------------------------------------


def test_each_slot_featurizes_under_its_own_device_scope(rng, monkeypatch):
    """K2's wrapper launches on the runtime's current device: each slot's
    Fisher features must be computed inside the scope of the slot's device.
    Eight slots of distinct (CPU-indexed) devices record the scope of every
    call of the K2 entry."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh(8, 1, devices=devices)
    scopes, calls = [], []

    @contextlib.contextmanager
    def recording_scope(dev):
        scopes.append(torch.device(dev))
        try:
            yield
        finally:
            scopes.pop()

    plain = pfisher.fv_stats

    def recorded(*args, **kw):
        calls.append(scopes[-1] if scopes else None)
        return plain(*args, **kw)

    images = [rng.uniform(0, 255, (12 + 4 * (i % 2), 10, 3)).astype(np.float32)
              for i in range(19)]
    describe = lambda px: px.mean(dim=3).reshape(px.shape[0], 4, -1)  # noqa: E731
    gmm = GaussianMixtureModel(torch.rand(4, 3) * 100, torch.rand(4, 3) * 50 + 10,
                               torch.full((3,), 1 / 3))
    fisher = pfv.fisher_feature_pipeline(gmm)
    whole = pfv.scatter_features(pfv.describe_buckets(images, describe, CPU, 4), fisher,
                                 19, 24)
    monkeypatch.setattr(pmesh, "device_scope", recording_scope)
    monkeypatch.setattr(pfisher, "fv_stats", recorded)
    buckets = pfv.describe_buckets(images, describe, CPU, 4, mesh=mesh)
    assert all(isinstance(d, ShardedRows) for _i, d in buckets.values())
    calls.clear()
    got = pfv.scatter_features(buckets, fisher, 19, 24)
    # Two buckets (10 and 9 images), eight slots each: one K2 call a slot.
    assert calls == devices * 2
    assert torch.equal(got, whole)


@pytest.fixture(scope="module")
def voc_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("voc_mesh")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "train.tar"), labels, 24, np.random.default_rng(42))
    return str(d / "train.tar"), labels


@pytest.fixture(scope="module")
def voc_plain(voc_data, hermetic_plan_log_module):  # noqa: F811
    conf = pvoc.SIFTFisherConfig(**VOC_CONF, device="cpu")
    data = ploaders.voc_loader(*voc_data)
    return conf, data, pvoc.run(conf, data, data)


@pytest.mark.parametrize("shape", list(MESHES))
def test_voc_run_on_a_mesh_is_the_unsharded_run(voc_plain, shape):
    conf, data, plain = voc_plain
    mesh = _mesh(*MESHES[shape])
    res = pvoc.run(conf, data, data, mesh=mesh)
    bundle = plain["bundle"]
    feats = {}
    for m in (None, mesh):
        desc = pvoc.extract_sift_buckets(conf, data.images, m)
        feats[m] = pfv.scatter_features(
            desc, Pipeline([bundle["pca"], pfv.fisher_feature_pipeline(bundle["gmm"])]),
            len(data), 2 * 16 * 8)
    assert torch.equal(feats[mesh], feats[None])
    assert torch.equal(res["bundle"]["pca"].pca_mat, bundle["pca"].pca_mat)
    assert torch.equal(res["bundle"]["gmm"].means, bundle["gmm"].means)
    assert res["fit_report"]["chosen_tier"] == f"fused[mesh {shape}]"
    assert set(res["placement"]) == {"solver", "featurize"}
    assert res["placement"]["featurize"]["chosen"] == f"row_sharded[mesh {shape}]"
    if MESHES[shape][0] == 1:
        np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])
    else:
        _close(res["test_scores"], plain["test_scores"])
    np.testing.assert_allclose(res["aps"], plain["aps"], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def inet_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet_mesh")
    rng = np.random.default_rng(8)
    _write_split(root, "train", 4, rng)
    _write_split(root, "test", 2, rng)
    labels = root / "labels.txt"
    labels.write_text("".join(f"syn{c:03d} {c}\n" for c in range(NUM_CLASSES)))
    return str(root / "train"), str(root / "test"), str(labels)


@pytest.fixture(scope="module")
def inet_plain(inet_data, hermetic_plan_log_module):  # noqa: F811
    conf = pinet.ImageNetSiftLcsFVConfig(**SMALL_CONF, device="cpu")
    train = ploaders.imagenet_loader(inet_data[0], inet_data[2])
    test = ploaders.imagenet_loader(inet_data[1], inet_data[2])
    return conf, train, test, pinet.run(conf, train, test)


@pytest.mark.parametrize("shape", ["4x2", "1x8"])
def test_imagenet_run_on_a_mesh_is_the_unsharded_run(inet_plain, shape):
    conf, train, test, plain = inet_plain
    mesh = _mesh(*MESHES[shape])
    res = pinet.run(conf, train, test, mesh=mesh)
    for branch in pinet.BRANCHES:
        sharded = pinet.branch_features(conf, train.images, test.images, branch, mesh)
        whole = pinet.branch_features(conf, train.images, test.images, branch)
        assert torch.equal(sharded[0], whole[0]) and torch.equal(sharded[1], whole[1])
    assert set(res["placement"]) == {"solver", "featurize_sift", "featurize_lcs"}
    assert res["placement"]["solver"]["chosen"] == f"fused[mesh {shape}]"
    if MESHES[shape][0] == 1:
        np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])
    else:
        _close(res["test_scores"], plain["test_scores"])
    assert res["top1_err_percent"] == plain["top1_err_percent"]
    assert res["top5_err_percent"] == plain["top5_err_percent"]


@pytest.mark.slow
def test_voc_mesh_run_matches_the_jax_mesh_run(voc_data, voc_plain, mesh8):
    conf, data, _plain = voc_plain
    res = pvoc.run(conf, data, data, mesh=_mesh(8, 1))
    jdata = jax_voc_loader(*voc_data)
    jconf = jax_voc.SIFTFisherConfig(**VOC_CONF)
    want = jax_voc.run(jconf, jdata, jdata, mesh=mesh8)
    np.testing.assert_allclose(res["aps"], want["aps"], rtol=0, atol=1e-6)


@pytest.mark.slow
def test_imagenet_mesh_run_matches_the_jax_mesh_run(inet_data, inet_plain, mesh42):
    conf, train, test, _plain = inet_plain
    res = pinet.run(conf, train, test, mesh=_mesh(4, 2))
    jconf = jax_inet.ImageNetSiftLcsFVConfig(**{k: v for k, v in SMALL_CONF.items()})
    jtrain = jax_imagenet_loader(inet_data[0], inet_data[2])
    jtest = jax_imagenet_loader(inet_data[1], inet_data[2])
    want = jax_inet.run(jconf, jtrain, jtest, mesh=mesh42)
    assert res["top1_err_percent"] == want["top1_err_percent"]
    assert res["top5_err_percent"] == want["top5_err_percent"]


# -- naive Bayes and Newsgroups ------------------------------------------------------


def test_naive_bayes_mesh_scores_are_the_serial_scores(rng):
    """21 documents over 8 data slots: 3 a slot, the last slot empty."""
    n, d, c = 21, 40, 3
    dense = (rng.random((n, d)) < 0.2) * rng.integers(1, 4, (n, d))
    dense[5] = 0  # a document with no terms
    indptr = np.concatenate([[0], np.cumsum((dense != 0).sum(axis=1))])
    rows, cols = np.nonzero(dense)
    csr = CSRFeatures(values=dense[rows, cols].astype(np.float32), indices=cols.astype(np.int32),
                      indptr=indptr, num_features=d)
    model = NaiveBayesModel(torch.from_numpy(rng.normal(size=c).astype(np.float32)),
                            torch.from_numpy(rng.normal(size=(c, d)).astype(np.float32)))
    serial = model(csr)
    for shape in ((8, 1), (4, 2)):
        with use_mesh(_mesh(*shape)):
            assert torch.equal(model(csr), serial)


@pytest.fixture(scope="module")
def ng_tree(tmp_path_factory):
    """The JAX twin's corpus: 3 themed classes, 10 train and 7 test
    documents each (21 test documents, not a multiple of 8)."""
    root = tmp_path_factory.mktemp("ng_mesh")
    rng = np.random.default_rng(42)
    themes = {
        "comp.graphics": ["pixel", "render", "shader", "gpu", "image"],
        "rec.autos": ["engine", "car", "wheel", "drive", "motor"],
        "sci.space": ["orbit", "rocket", "nasa", "launch", "moon"],
    }
    for split in ("train", "test"):
        for cls, words in themes.items():
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(10 if split == "train" else 7):
                (d / f"doc{i}.txt").write_text(" ".join(rng.choice(words, 25).tolist()))
    return str(root), tuple(themes)


def test_newsgroups_run_on_a_mesh_is_the_unsharded_run_and_jax(ng_tree, mesh8):
    root, classes = ng_tree
    conf = png.NewsgroupsConfig(n_grams=2, common_features=3000, classes=classes,
                                device="cpu")
    train = newsgroups_loader(f"{root}/train", list(classes))
    test = newsgroups_loader(f"{root}/test", list(classes))
    plain = png.run(conf, train, test)
    sharded = png.run(conf, train, test, mesh=_mesh(8, 1))
    np.testing.assert_array_equal(sharded["test_scores"], plain["test_scores"])
    assert len(test.data) == 21 and sharded["test_error"] == plain["test_error"]
    jconf = jax_ng.NewsgroupsConfig(n_grams=2, common_features=3000, classes=classes)
    jtrain = jax_ng_loader(f"{root}/train", list(classes))
    jtest = jax_ng_loader(f"{root}/test", list(classes))
    want = jax_ng.run(jconf, jtrain, jtest, mesh=mesh8)
    assert abs(sharded["test_error"] - want["test_error"]) < 1e-9


# -- the CLIs ------------------------------------------------------------------------


def test_cli_mesh_flag_refusals(voc_data, inet_data, tmp_path):
    """``--mesh`` is taken, and beside it ``--autoCache`` and
    ``--pipelineFile``: the scores equal the ``--mesh 1`` run's, and the
    saved bundle restores to them; a mesh of more slots than the CPU has
    devices raises as the JAX package does."""
    voc = ["--trainLocation", voc_data[0], "--testLocation", voc_data[0], "--labelPath",
           voc_data[1], "--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
           "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--device", "cpu"]
    inet = ["--trainLocation", inet_data[0], "--testLocation", inet_data[1], "--labelPath",
            inet_data[2], *INET_FLAGS, "--device", "cpu"]
    for name, main, base in (("voc", pvoc.main, voc), ("inet", pinet.main, inet)):
        base = [*base, "--mesh", "1"]
        plain = main(base)
        stem = str(tmp_path / name)
        # --autoCache; --pipelineFile fits and saves; again, it restores.
        for flags, restored in ((["--autoCache"], False), (["--pipelineFile", stem], False),
                                (["--pipelineFile", stem], True)):
            res = main([*base, *flags])
            assert res.get("restored", False) == restored
            np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])
        with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 1"):
            main([*base[:-2], "--mesh", "8"])
