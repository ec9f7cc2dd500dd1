"""The ImageNetSiftLcsFV slice as a whole (CPU): the loader, the top-k
nodes, SIFT at scale step 1, the whole ``run`` against the JAX package's
with both branches' PCA and GMM shared through the eight ``*File`` flags,
the fitted state carried across with ``convert``, the CLI on synthetic
synset tars (eager, and streamed with host and device decode), and its
refusals.

Tolerances: the loader's labels and names, top-k indices and error
percentages exactly; the JAX-fitted PCA/GMM reach both packages through
the same CSV files, and each package's test scores lie within 1e-2·max of
an f64 evaluation of the same run (f64 descriptors through PCA, Fisher
vectors and the weighted solve): the f32 Fisher vectors of uncentred PCA
descriptors sit a few 1e-3·max from f64 in any implementation (see
``test_torch_voc_sift_fisher.py``).  Top-1 and top-5 errors are equal.
The streamed CLI with host decode reproduces the eager CLI exactly; with
device decode it is held within 1e-2·max to the eager run on the port's own
CPU decode of the same JPEGs (decoders differ by IDCT rounding)."""

import dataclasses
import io
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.loaders.image_loaders import imagenet_labels_map as jax_labels_map
from keystone_tpu.loaders.image_loaders import imagenet_loader as jax_imagenet_loader
from keystone_tpu.ops import util as jutil
from keystone_tpu.ops.sift import SIFTExtractor as JaxSIFT
from keystone_tpu.solvers.weighted import BlockWeightedLeastSquaresEstimator as JaxBWLS
from keystone_tpu.utils.stats import get_err_percent as jax_err_percent
from keystone_tpu.workloads import fv_common as jfv
from keystone_tpu.workloads import imagenet_sift_lcs_fv as jinet
from keystone_tpu_torch import convert
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import util as putil
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.solvers.pca import BatchPCATransformer
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.utils.stats import get_err_percent
from keystone_tpu_torch.workloads import fv_common as pfv
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as pinet
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

NUM_CLASSES = 6
SHAPES = ((48, 64), (56, 72))
LAM, MIX = 1e-3, 0.25
SMALL = ["--lambda", str(LAM), "--mixtureWeight", str(MIX), "--descDim", "12",
         "--vocabSize", "4", "--numPcaSamples", "4000", "--numGmmSamples", "4000",
         "--lcsStride", "8", "--numClasses", str(NUM_CLASSES)]
SMALL_CONF = dict(lam=LAM, mixture_weight=MIX, desc_dim=12, vocab_size=4,
                  num_pca_samples=4000, num_gmm_samples=4000, lcs_stride=8,
                  num_classes=NUM_CLASSES)
FILE_FLAGS = {"sift_pca_file": "--siftPcaFile", "sift_gmm_mean_file": "--siftGmmMeanFile",
              "sift_gmm_var_file": "--siftGmmVarFile", "sift_gmm_wts_file": "--siftGmmWtsFile",
              "lcs_pca_file": "--lcsPcaFile", "lcs_gmm_mean_file": "--lcsGmmMeanFile",
              "lcs_gmm_var_file": "--lcsGmmVarFile", "lcs_gmm_wts_file": "--lcsGmmWtsFile"}


def _class_image(rng, c, h, w):
    """RGB uint8: a class colour, a class grating in one channel, noise."""
    palette = np.array([[200, 60, 60], [60, 200, 60], [60, 60, 200],
                        [200, 200, 60], [60, 200, 200], [200, 60, 200]], np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    angle = np.pi * c / NUM_CLASSES
    img = np.zeros((h, w, 3)) + palette[c % len(palette)]
    img[:, :, c % 3] += 45 * np.sin((xx * np.cos(angle) + yy * np.sin(angle)) / (1.5 + c % 3)
                                    + rng.uniform(0, 2 * np.pi))
    img += rng.normal(0, 12, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _jpeg(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _write_split(root, split, per_class, rng):
    (root / split).mkdir()
    for c in range(NUM_CLASSES):
        with tarfile.open(root / split / f"syn{c:03d}.tar", "w") as tf:
            for i in range(per_class):
                data = _jpeg(_class_image(rng, c, *SHAPES[(i + c) % 2]))
                info = tarfile.TarInfo(f"syn{c:03d}/{split}_{i}.JPEG")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    # A synset the labels file does not name: filtered out.
    with tarfile.open(root / split / "zzz.tar", "w") as tf:
        data = _jpeg(_class_image(rng, 0, *SHAPES[0]))
        info = tarfile.TarInfo("nsyn/x.JPEG")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    """Synset tars of 6 classes at two sizes: 4 train and 2 test images per
    class, and the labels file (with a short line the parser skips)."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(8)
    _write_split(root, "train", 4, rng)
    _write_split(root, "test", 2, rng)
    labels = root / "labels.txt"
    labels.write_text("".join(f"syn{c:03d} {c}\n" for c in range(NUM_CLASSES)) + "orphan\n")
    return str(root / "train"), str(root / "test"), str(labels)


@pytest.fixture(scope="module")
def jax_state(tars, tmp_path_factory):
    """Both branches' PCA and GMM fitted by the JAX package and written as
    the CSVs of the eight ``*File`` flags; then the JAX run with those
    files (its errors) and, stage by stage, its test scores and model."""
    train_dir, test_dir, labels = tars
    train = jax_imagenet_loader(train_dir, labels)
    test = jax_imagenet_loader(test_dir, labels)
    conf = jinet.ImageNetSiftLcsFVConfig(**SMALL_CONF)
    d = tmp_path_factory.mktemp("state")
    files, arrays = {}, {}
    for branch, fn, seed in (("sift", jinet.sift_descriptor_buckets, conf.seed),
                             ("lcs", jinet.lcs_descriptor_buckets, conf.seed + 100)):
        _, _, pca, gmm, _ = jinet.branch_features(
            conf, train.images, test.images, fn, None, (None, None, None), seed)
        arrays[f"{branch}_pca_mat"] = np.asarray(pca.pca_mat)
        for key, a in (("means", gmm.means), ("variances", gmm.variances),
                       ("weights", gmm.weights)):
            arrays[f"{branch}_gmm_{key}"] = np.asarray(a)
        for key, flag, a in (("pca_file", "pca", np.asarray(pca.pca_mat).T),
                             ("gmm_mean_file", "means", np.asarray(gmm.means)),
                             ("gmm_var_file", "vars", np.asarray(gmm.variances)),
                             ("gmm_wts_file", "wts", np.asarray(gmm.weights)[None])):
            path = str(d / f"{branch}_{flag}.csv")
            np.savetxt(path, a, delimiter=",", fmt="%.9e")
            files[f"{branch}_{key}"] = path
    # The run also writes the JAX package's fitted bundle, which the port
    # restores with --pipelineFile.
    conf = dataclasses.replace(conf, **files, pipeline_file=str(d / "jax_bundle"))
    errors = jinet.run(conf, train, test)

    feats = []
    for fn, branch in ((jinet.sift_descriptor_buckets, "sift"), (jinet.lcs_descriptor_buckets, "lcs")):
        pca_file = files[f"{branch}_pca_file"]
        gmm_files = tuple(files[f"{branch}_gmm_{k}_file"] for k in ("mean", "var", "wts"))
        feats.append(jinet.branch_features(conf, train.images, test.images, fn, pca_file,
                                           gmm_files, 0)[:2])
    train_f = np.concatenate([np.asarray(f[0]) for f in feats], axis=1)
    test_f = np.concatenate([np.asarray(f[1]) for f in feats], axis=1)
    indicators = jutil.ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    model = JaxBWLS(4096, 1, LAM, MIX).fit(train_f, indicators, num_features=train_f.shape[1])
    arrays["model_xs"] = [np.asarray(x) for x in model.xs]
    arrays["model_b"] = np.asarray(model.b)
    return {"files": files, "errors": errors, "arrays": arrays,
            "scores": np.asarray(model(jnp.asarray(test_f))), "test_labels": test.labels,
            "bundle": conf.pipeline_file}


def _flags(files):
    return [a for key, path in files.items() for a in (FILE_FLAGS[key], path)]


def _base(tars):
    train_dir, test_dir, labels = tars
    return ["--trainLocation", train_dir, "--testLocation", test_dir, "--labelPath", labels]


def _f64_features(conf, images, branch, arrays):
    """``branch``'s features of ``images`` in f64: the port's descriptors,
    then PCA, Fisher vectors and the normalisations in f64."""
    pca = BatchPCATransformer(torch.from_numpy(arrays[f"{branch}_pca_mat"]).double())
    gmm = GaussianMixtureModel(*(torch.from_numpy(arrays[f"{branch}_gmm_{k}"]).double()
                                 for k in ("means", "variances", "weights")))
    fisher = pfv.fisher_feature_pipeline(gmm)
    buckets = pinet.descriptor_buckets(conf, images, branch)
    feats = torch.zeros((len(images), 2 * conf.desc_dim * conf.vocab_size), dtype=torch.float64)
    for idx, descs in buckets.values():
        feats[torch.from_numpy(idx)] = fisher(pca(descs.double()))
    return feats


def _f64_run_scores(tars, arrays):
    """The whole run in f64 on the shared PCA/GMM: features of both splits
    and the weighted solve."""
    train_dir, test_dir, labels = tars
    train = ploaders.imagenet_loader(train_dir, labels)
    test = ploaders.imagenet_loader(test_dir, labels)
    conf = pinet.ImageNetSiftLcsFVConfig(**SMALL_CONF, device="cpu")
    tr = torch.cat([_f64_features(conf, train.images, b, arrays) for b in pinet.BRANCHES], 1)
    te = torch.cat([_f64_features(conf, test.images, b, arrays) for b in pinet.BRANCHES], 1)
    indicators = putil.ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels).double()
    model = BlockWeightedLeastSquaresEstimator(4096, 1, LAM, MIX).fit(tr, indicators)
    return model(te).numpy(), te


def _within(got, exact, share=1e-2):
    assert np.abs(got - exact).max() <= share * np.abs(exact).max()


def test_run_matches_jax_with_shared_pca_and_gmm(tars, jax_state, monkeypatch):
    monkeypatch.setattr(fs, "launches", 0)
    port = pinet.main([*_base(tars), *SMALL, *_flags(jax_state["files"]), "--device", "cpu"])
    assert fs.launches == 0  # the CPU path runs the plain version
    errors = jax_state["errors"]
    assert port["top5_err_percent"] == errors["top5_err_percent"]
    assert port["top1_err_percent"] == errors["top1_err_percent"]
    assert port["top5_err_percent"] < 50.0
    np.testing.assert_array_equal(port["test_labels"], jax_state["test_labels"])
    exact, _ = _f64_run_scores(tars, jax_state["arrays"])
    _within(port["test_scores"], exact)
    _within(jax_state["scores"], exact)
    for key in ("seconds", "sift_branch_seconds", "lcs_branch_seconds", "solve_seconds",
                "eval_seconds", "featurize_images_per_sec"):
        assert port[key] > 0


def test_carried_jax_state_scores_like_jax(tars, jax_state):
    arrays = jax_state["arrays"]
    fitted = convert.imagenet_from_arrays(**arrays, lcs_stride=8, device="cpu")
    assert fitted.conf.desc_dim == 12 and fitted.conf.vocab_size == 4
    test = ploaders.imagenet_loader(tars[1], tars[2])
    got = fitted.scores(test.images).numpy()
    _, exact_feats = _f64_run_scores(tars, arrays)
    model = fitted.bundle["model"]
    exact = (exact_feats @ torch.cat(model.xs).double() + model.b.double()).numpy()
    _within(got, exact)
    _within(jax_state["scores"], exact)
    back = convert.imagenet_to_arrays(fitted.bundle, fitted.conf)
    for key, value in arrays.items():
        if key == "model_xs":
            for a, b in zip(back[key], value):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(back[key], value)
    assert (back["lcs_stride"], back["sift_scale_step"]) == (8, 1)


@pytest.fixture(scope="module")
def port_run(tars):
    conf = pinet.ImageNetSiftLcsFVConfig(**SMALL_CONF, device="cpu")
    test = ploaders.imagenet_loader(tars[1], tars[2])
    res = pinet.run(conf, ploaders.imagenet_loader(tars[0], tars[2]), test)
    return conf, test, res


def test_convert_round_trip_reproduces_the_run(port_run):
    conf, test, res = port_run
    arrays = convert.imagenet_to_arrays(res["bundle"], conf)
    fitted = convert.imagenet_from_arrays(**arrays, device="cpu")
    np.testing.assert_array_equal(fitted.scores(test.images).numpy(), res["test_scores"])
    again = convert.imagenet_to_arrays(fitted.bundle, fitted.conf)
    assert sorted(again) == sorted(arrays)
    np.testing.assert_array_equal(again["sift_pca_mat"], arrays["sift_pca_mat"])
    np.testing.assert_array_equal(again["model_b"], arrays["model_b"])


def test_branch_test_features_are_batch_invariant(port_run):
    """Served batches of 1 and 3 images against one call on the whole split.
    On the CPU the plain Fisher statistics sum in BLAS order, which may
    depend on the batch (single-ulp differences in near-zero entries):
    rtol 1e-5, atol 1e-7·max.  On the card the kernel's fixed splits make
    them bit-equal (``chip_smoke.py`` phase 17 holds the scores to
    1e-4·max)."""
    conf, test, res = port_run
    bundle = res["bundle"]
    for branch in pinet.BRANCHES:
        pca, gmm = bundle[f"{branch}_pca"], bundle[f"{branch}_gmm"]
        whole = pinet.branch_test_features(conf, test.images, branch, pca, gmm)
        for b in (1, 3):
            parts = torch.cat([
                pinet.branch_test_features(conf, test.images[i : i + b], branch, pca, gmm)
                for i in range(0, len(test), b)
            ])
            torch.testing.assert_close(parts, whole, rtol=1e-5,
                                       atol=1e-7 * whole.abs().max().item())


def test_cli_streams_jpeg_tars(tars, port_run, monkeypatch):
    monkeypatch.setattr(fs, "launches", 0)
    monkeypatch.setattr(jd, "launches", 0)
    conf, test, res = port_run
    stream = [*_base(tars), *SMALL, "--device", "cpu", "--streamIngest", "--streamBatchSize", "5"]
    host = pinet.main(stream)
    assert host["test_filenames"] == res["test_filenames"]
    np.testing.assert_array_equal(host["test_scores"], res["test_scores"])

    device = pinet.main([*stream, "--deviceDecode"])
    assert fs.launches == 0 and jd.launches == 0  # the CPU path runs the plain versions
    for split, count in (("train", 4 * NUM_CLASSES), ("test", 2 * NUM_CLASSES)):
        passes = device["ingest"][split]
        assert len(passes) == 2  # one per branch, the same survivors
        for st in passes:
            assert st["entropy_decoded"] == st["decoded"] == count
            assert st["skipped"] == st["device_fallbacks"] == 0
    same_pixels = [_cpu_decoded(tars[i], tars[2]) for i in (0, 1)]
    eager = pinet.run(conf, *same_pixels)
    assert device["test_filenames"] == eager["test_filenames"]
    _within(device["test_scores"], eager["test_scores"])
    assert device["top5_err_percent"] == eager["top5_err_percent"]
    assert device["top1_err_percent"] == eager["top1_err_percent"]


def _cpu_decoded(path, labels):
    """A split as the port's CPU decode of each JPEG's coefficients."""
    eager = ploaders.imagenet_loader(path, labels)
    members = dict(ploaders._iter_tar_members(path))
    images = []
    for name in eager.filenames:
        ci = jd.entropy_decode(members[name])
        images.append(jd.decode_batch(ci.geom, *jd.stack_coeff_images([ci]), "cpu")[0].numpy())
    return ploaders.LabeledImages(images, eager.labels, eager.filenames)


def test_pipeline_file_restores_the_fitted_predictions(tars, tmp_path):
    """A fit saves the bundle; the run that finds it reads no training data,
    fits nothing and gives the fitted run's scores and errors."""
    stem = str(tmp_path / "inet")
    argv = [*_base(tars), *SMALL, "--device", "cpu", "--pipelineFile", stem]
    fitted = pinet.main(argv)
    assert "restored" not in fitted
    missing = ["--trainLocation", str(tmp_path / "absent")]
    restored = pinet.main([*argv, *missing])
    assert restored["restored"] is True
    np.testing.assert_array_equal(restored["test_scores"], fitted["test_scores"])
    assert restored["top5_err_percent"] == fitted["top5_err_percent"]
    assert restored["top1_err_percent"] == fitted["top1_err_percent"]


def test_jax_bundle_restores_in_the_port(tars, jax_state, tmp_path):
    """The JAX package's saved bundle loads into the port, which scores the
    test split at the JAX run's errors, within the f64 bar of
    :func:`test_run_matches_jax_with_shared_pca_and_gmm`."""
    port = pinet.main(["--trainLocation", str(tmp_path / "absent"), *_base(tars)[2:], *SMALL,
                       "--device", "cpu", "--pipelineFile", jax_state["bundle"]])
    assert port["restored"] is True
    errors = jax_state["errors"]
    assert port["top5_err_percent"] == errors["top5_err_percent"]
    assert port["top1_err_percent"] == errors["top1_err_percent"]
    exact, _ = _f64_run_scores(tars, jax_state["arrays"])
    _within(port["test_scores"], exact)


def test_auto_cache_with_shared_pca_and_gmm_matches_jax(tars, jax_state):
    """With the PCA and GMM loaded the projected descriptors feed one
    consumer, so the auto-Cacher keeps nothing (reuse 1) and each branch
    re-projects per bucket: the scores equal the plain run's, the errors
    the JAX run's."""
    argv = [*_base(tars), *SMALL, *_flags(jax_state["files"]), "--device", "cpu"]
    plain = pinet.main(argv)
    cached = pinet.main([*argv, "--autoCache"])
    np.testing.assert_array_equal(cached["test_scores"], plain["test_scores"])
    for branch in pinet.BRANCHES:
        (dec,) = cached["cache_plan"][branch]["decisions"]
        assert (dec["name"], dec["reuse"], dec["cached"]) == (f"{branch}_pca_descriptors", 1,
                                                               False)
    errors = jax_state["errors"]
    assert cached["top5_err_percent"] == errors["top5_err_percent"]
    assert cached["top1_err_percent"] == errors["top1_err_percent"]


def test_auto_shard_records_the_placement(tars, port_run, monkeypatch, tmp_path):
    """``--autoShard`` forces the placement search of the weighted solve:
    the results carry its table, and the scores are the plain run's.  The
    test's own empty plan log keeps the untrained ranking."""
    monkeypatch.setenv("KEYSTONE_PLAN_LOG", str(tmp_path / "plans.jsonl"))
    res = pinet.main([*_base(tars), *SMALL, "--device", "cpu", "--autoShard"])
    _, _, plain = port_run
    np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])
    placement = res["placement"]
    assert placement["label"] == "bwls_fit"
    assert placement["ranking"] == ["fused", "stepwise", "host_staged"]
    assert placement["chosen"] == "fused"


@pytest.mark.parametrize("budget", [None, "1K"])
def test_auto_cache_fitting_branches_is_bit_equal(tars, port_run, budget, monkeypatch):
    """Fitting the GMMs (reuse 2): materialized with no budget known, or
    re-projected per consumer when the budget denies it, the scores are the
    plain run's bit for bit."""
    if budget is None:
        monkeypatch.delenv("KEYSTONE_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("KEYSTONE_HBM_BUDGET", budget)
    res = pinet.main([*_base(tars), *SMALL, "--device", "cpu", "--autoCache"])
    _, _, plain = port_run
    np.testing.assert_array_equal(res["test_scores"], plain["test_scores"])
    for branch in pinet.BRANCHES:
        assert res["cache_plan"][branch]["cached"] == (
            [] if budget else [f"{branch}_pca_descriptors"])


def test_cli_auto_tune_streams_equal(tars, port_run, monkeypatch):
    """``--autoTune`` with the controller evaluating every chunk: each
    streamed pass carries its tuner's record, and the scores equal the
    eager run's."""
    monkeypatch.setenv("KEYSTONE_AUTOTUNE_INTERVAL", "1")
    _, _, res = port_run
    tuned = pinet.main([*_base(tars), *SMALL, "--device", "cpu", "--streamIngest",
                        "--streamBatchSize", "3", "--autoTune"])
    np.testing.assert_array_equal(tuned["test_scores"], res["test_scores"])
    for split in ("train", "test"):
        records = tuned["autotune"][split]
        assert len(records) == 2  # one stream per branch
        assert all(set(r) == {"retunes", "trajectory", "final_config"} for r in records)


@pytest.mark.parametrize("flags", [
    ["--serve"], ["--autoTune"], ["--autoShard", "--mesh", "8"], ["--mesh", "8"],
    ["--serveBench"], ["--streamIngest", "--serveMesh", "2x1"],
    ["--decodeBackend", "thread"], ["--snapshotDir", "s"],  # both need --streamIngest
    ["--deviceDecode"],
])
def test_cli_rejects_unported_flags(tars, flags):
    """Usage errors, but ``--mesh``: it is taken, and a mesh of more slots
    than the CPU has devices raises as the JAX package does."""
    if "--mesh" in flags:
        with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 1"):
            pinet.main([*_base(tars), *SMALL, "--device", "cpu", *flags])
        return
    with pytest.raises(SystemExit):
        pinet.main([*_base(tars), *SMALL, "--device", "cpu", *flags])


def test_default_device_needs_a_card(tars, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pinet.main(_base(tars))
    data = ploaders.LabeledImages([], np.zeros(0, np.int32), [])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pinet.run(pinet.ImageNetSiftLcsFVConfig(), data, data)


def test_stream_source_checks_its_passes(tars):
    src = pinet.imagenet_stream_source(tars[0], tars[2])
    with pytest.raises(RuntimeError, match="before its first pass"):
        len(src)
    src.record_names(["syn000/a.JPEG", "syn001/b.JPEG"])
    np.testing.assert_array_equal(src.labels, [0, 1])
    src.record_names(["syn000/a.JPEG", "syn001/b.JPEG"])
    with pytest.raises(RuntimeError, match="drifted"):
        src.record_names(["syn001/b.JPEG", "syn000/a.JPEG"])


def test_labels_map_and_loader_match_jax(tars):
    train_dir, _, labels = tars
    assert ploaders.imagenet_labels_map(labels) == jax_labels_map(labels)
    got, ref = ploaders.imagenet_loader(train_dir, labels), jax_imagenet_loader(train_dir, labels)
    assert len(got) == 4 * NUM_CLASSES  # the unnamed synset is filtered out
    assert got.filenames == ref.filenames
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.labels.dtype == np.int32
    for a, b in zip(got.images, ref.images):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).mean() <= 1.0  # PIL against libjpeg: IDCT rounding


def test_topk_and_error_percent_match_jax(rng):
    scores = rng.normal(size=(40, 30)).astype(np.float32)  # no exact ties
    labels = rng.integers(0, 30, 40)
    for k in (1, 5, 30):
        got = putil.TopKClassifier(k)(torch.from_numpy(scores)).numpy()
        ref = np.asarray(jutil.TopKClassifier(k)(jnp.asarray(scores)))
        np.testing.assert_array_equal(got, ref)
        assert get_err_percent(got, labels, k) == jax_err_percent(ref, labels, k)
    top5 = putil.TopKClassifier(5)(torch.from_numpy(scores)).numpy()
    assert get_err_percent(top5, labels, 1) == jax_err_percent(top5, labels, 1)
    assert get_err_percent(labels[:, None], labels) == 0.0


def test_cast_nodes(rng):
    x = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
    out = putil.FloatToDouble(torch.float64)(x)
    assert out.dtype == torch.float64 and torch.equal(out.float(), x)
    assert putil.Cast(torch.bfloat16)(x).dtype == torch.bfloat16
    ref = np.asarray(jutil.Cast(jnp.bfloat16)(jnp.asarray(x.numpy())).astype(jnp.float32))
    np.testing.assert_array_equal(putil.Cast(torch.bfloat16)(x).float().numpy(), ref)


def test_sift_at_scale_step_one_matches_jax(rng):
    """The workload's SIFT: step 3, scale step 1, bf16 intermediates, on
    the grayscale of BGR pixels; >= 99.5 % of the quantised entries within
    +-1 of the JAX package's (the SIFT tests' bar)."""
    h, w = 67, 91
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([90 + 60 * np.sin(xx / 3.0 + c) * np.cos(yy / 5.0) for c in range(3)], -1)
    img = np.clip(img[None] + rng.normal(0, 10, (2, h, w, 3)), 0, 255).astype(np.float32)
    jsift = JaxSIFT(scale_step=1, compute_dtype=jnp.bfloat16)
    ref = np.asarray(jsift(jfv.grayscale(jnp.asarray(img))))
    psift = SIFTExtractor(scale_step=1, compute_dtype=torch.bfloat16)
    got = psift(pfv.grayscale(torch.from_numpy(img))).numpy()
    assert got.shape == ref.shape == (2, 128, psift.num_descriptors(h, w))
    assert np.mean(np.abs(got - ref) <= 1.0) >= 0.995
    describe = pinet.make_describe(pinet.ImageNetSiftLcsFVConfig(device="cpu"), "sift")
    np.testing.assert_array_equal(describe(torch.from_numpy(img)).numpy(), np.sqrt(got))


@pytest.mark.parametrize("h,w,count", [(375, 500, 40584), (333, 500, 35841)])
def test_sift_descriptor_counts_at_imagenet_sizes(h, w, count):
    assert SIFTExtractor(scale_step=1).num_descriptors(h, w) == count
    assert JaxSIFT(scale_step=1).num_descriptors(h, w) == count
