"""The VOCSIFTFisher slice as a whole (CPU): the port's CLI on a synthetic
VOC tar, one JAX-fitted state carried into the port through
``keystone_tpu_torch.convert``, the MAP evaluator, the loader and the
slice's small nodes, each against the JAX package.

Tolerances: MAP and label indicators exactly; elementwise nodes rtol 1e-6
(the grayscale weights 1e-6·255).  For the carried-over state, the Fisher
sufficient statistics from identical descriptors match JAX's to rtol 2e-4,
atol 2e-5·max.  The Fisher vectors, features and scores assembled from
them are held, in both packages alike, within 1e-2·max of an f64
evaluation of the same chain: PCA-projected SIFT descriptors are not
centred (values in the hundreds), so ``s2 - 2 mu s1 + (mu^2 - var) s0``
cancels and any f32 chain lands a few 1e-3·max from f64 (measured: port
4.3e-3, JAX 2.4e-3 at most), the signed square root magnifying the
near-zero entries.  On well-conditioned data ``test_torch_fisher.py``
holds the Fisher vectors of the two packages to 2e-4 / 2e-5.

The streamed CLI (``--streamIngest``) is held to the eager CLI on the same
pixels within that 1e-2·max bar: host decode against the eager loader's
PIL pixels, device decode against the port's own CPU decode of the same
JPEGs.  Device-decoded pixels differ from PIL's by IDCT rounding (within
the golden bounds of ``test_torch_jpeg_device.py``), and at this size (24
images, λ 0.05) that alone moves a fitted model's scores far past the bar,
so the two decoders are compared by the APs of the present classes, not by
scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.evaluation.map import mean_average_precision as jax_map
from keystone_tpu.loaders.image_loaders import voc_loader as jax_voc_loader
from keystone_tpu.ops import images as jimages
from keystone_tpu.ops import stats as jstats
from keystone_tpu.ops import util as jutil
from keystone_tpu.ops.fisher import FisherVector as JaxFisherVector
from keystone_tpu.ops.sift import SIFTExtractor as JaxSIFT
from keystone_tpu.solvers.block import BlockLeastSquaresEstimator as JaxBLS
from keystone_tpu.solvers.gmm import GaussianMixtureModel as JaxGMM
from keystone_tpu.solvers.gmm import _log_resp as jax_log_resp
from keystone_tpu.solvers.gmm import GaussianMixtureModelEstimator as JaxGMMEstimator
from keystone_tpu.solvers.pca import BatchPCATransformer as JaxBatchPCA, compute_pca as jax_pca
from keystone_tpu.workloads import fv_common as jfv
from keystone_tpu_torch import convert
from keystone_tpu_torch.evaluation.map import mean_average_precision
from keystone_tpu_torch.loaders import image_loaders as ploaders
from keystone_tpu_torch.loaders.image_loaders import MultiLabeledImages
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import images as pimages
from keystone_tpu_torch.ops import stats as pstats
from keystone_tpu_torch.ops import util as putil
from keystone_tpu_torch.ops.fisher import FisherVector, fisher_vector
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.workloads import fv_common as pfv
from keystone_tpu_torch.workloads import voc_sift_fisher as pvoc
from test_fisher_pipelines import _class_image, write_voc_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

SMALL = ["--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
         "--numPcaSamples", "6000", "--numGmmSamples", "6000"]


@pytest.fixture(scope="module")
def voc_tar(tmp_path_factory):
    """24 JPEGs of 4 separable classes and their labels CSV (one tar serves
    both splits, as in the JAX package's end-to-end test)."""
    d = tmp_path_factory.mktemp("voc")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "train.tar"), labels, 24, np.random.default_rng(42))
    return str(d / "train.tar"), labels


def test_port_cli_separates_the_present_classes(voc_tar, monkeypatch):
    monkeypatch.setattr(fs, "launches", 0)
    tar, labels = voc_tar
    res = pvoc.main(["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
                     "--scaleStep", "0", *SMALL, "--device", "cpu"])
    # 16 of the 20 VOC classes have no positives (AP 0 by definition); the
    # criterion is the AP of the 4 present classes, as for the JAX package.
    assert np.all(res["aps"][:4] > 0.9), res["aps"]
    for key in ("sift_seconds", "pca_seconds", "gmm_seconds", "fisher_seconds",
                "solve_seconds", "eval_seconds", "seconds", "featurize_images_per_sec"):
        assert res[key] > 0
    assert fs.launches == 0  # the CPU path runs the plain version

    conf = pvoc.SIFTFisherConfig(sift_step_size=3, scale_step=0, device="cpu")
    data = ploaders.voc_loader(tar, labels)
    batch = torch.from_numpy(np.stack(data.images))
    served = pvoc.servable_pipeline(conf, res["bundle"])(batch).numpy()
    np.testing.assert_allclose(served, res["test_scores"], rtol=0, atol=1e-4 * np.abs(served).max())
    again = convert.voc_from_arrays(**convert.voc_to_arrays(pvoc.servable_pipeline(conf, res["bundle"])),
                                    device="cpu")
    np.testing.assert_array_equal(again.servable(batch).numpy(), served)


def test_cli_loads_pca_and_gmm_files(voc_tar, tmp_path):
    """--pcaFile / --gmm*File skip the fits and reproduce the fitted run."""
    tar, labels = voc_tar
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--scaleStep", "0", *SMALL, "--device", "cpu"]
    fitted = pvoc.main(base)
    bundle = fitted["bundle"]
    files = {name: str(tmp_path / f"{name}.csv") for name in ("pca", "means", "vars", "wts")}
    np.savetxt(files["pca"], bundle["pca"].pca_mat.numpy().T, delimiter=",")
    np.savetxt(files["means"], bundle["gmm"].means.numpy(), delimiter=",")
    np.savetxt(files["vars"], bundle["gmm"].variances.numpy(), delimiter=",")
    np.savetxt(files["wts"], bundle["gmm"].weights.numpy()[None], delimiter=",")
    loaded = pvoc.main([*base, "--pcaFile", files["pca"], "--gmmMeanFile", files["means"],
                        "--gmmVarFile", files["vars"], "--gmmWtsFile", files["wts"]])
    np.testing.assert_array_equal(loaded["test_scores"], fitted["test_scores"])


def _device_decoded(tar, labels) -> MultiLabeledImages:
    """The VOC split as the port's CPU decode of each JPEG's coefficients."""
    eager = ploaders.voc_loader(tar, labels)
    members = dict(ploaders._iter_tar_members(tar))
    images = []
    for name in eager.filenames:
        ci = jd.entropy_decode(members[name])
        images.append(jd.decode_batch(ci.geom, *jd.stack_coeff_images([ci]), "cpu")[0].numpy())
    return MultiLabeledImages(images, eager.labels, eager.filenames)


def test_port_cli_streams_jpeg_tars(voc_tar, monkeypatch):
    monkeypatch.setattr(fs, "launches", 0)
    monkeypatch.setattr(jd, "launches", 0)
    tar, labels = voc_tar
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--scaleStep", "0", *SMALL, "--device", "cpu", "--streamIngest",
            "--streamBatchSize", "5"]
    device = pvoc.main([*base, "--deviceDecode"])
    assert np.all(device["aps"][:4] > 0.9), device["aps"]
    assert fs.launches == 0 and jd.launches == 0  # the CPU path runs the plain versions
    for split in ("train", "test"):
        stats = device["ingest"][split]
        assert stats["entropy_decoded"] == stats["decoded"] == 24
        assert stats["skipped"] == stats["device_fallbacks"] == 0
        assert stats["batches"] == 5  # 24 images of one shape: four chunks of 5, a tail of 4

    conf = pvoc.SIFTFisherConfig(lam=0.05, desc_dim=16, vocab_size=8, num_pca_samples=6000,
                                 num_gmm_samples=6000, scale_step=0, device="cpu")
    same_pixels = _device_decoded(tar, labels)
    eager = pvoc.run(conf, same_pixels, same_pixels)
    assert device["test_filenames"] == eager["test_filenames"]
    bar = 1e-2 * np.abs(eager["test_scores"]).max()
    assert np.abs(device["test_scores"] - eager["test_scores"]).max() <= bar

    host = pvoc.main(base)
    eager_pil = pvoc.main(base[: base.index("--streamIngest")])
    assert host["test_filenames"] == eager_pil["test_filenames"]
    bar = 1e-2 * np.abs(eager_pil["test_scores"]).max()
    assert np.abs(host["test_scores"] - eager_pil["test_scores"]).max() <= bar
    np.testing.assert_array_equal(host["aps"][:4], device["aps"][:4])


@pytest.mark.parametrize("flags", [["--autoTune"], ["--decodeBackend", "thread"],
                                   ["--snapshotDir", "snaps"], ["--deviceDecode"]])
def test_cli_rejects_unported_stream_flags(voc_tar, flags):
    tar, labels = voc_tar
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels,
            "--device", "cpu"]
    # Each of these stream flags needs --streamIngest.
    with pytest.raises(SystemExit):
        pvoc.main([*base, *flags])


def test_cli_rejects_unported_flags_and_needs_a_card(voc_tar, monkeypatch):
    """``--mesh`` is taken and refuses a mesh of more slots than the CPU has
    devices, as the JAX package does; beside it ``--autoCache`` is taken,
    with the scores of the ``--mesh 1`` run."""
    tar, labels = voc_tar
    base = ["--trainLocation", tar, "--testLocation", tar, "--labelPath", labels]
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices, have 1"):
        pvoc.main([*base, "--mesh", "8", "--device", "cpu"])
    small = [*base, "--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
             "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--mesh", "1",
             "--device", "cpu"]
    cached = pvoc.main([*small, "--autoCache"])
    assert cached["cache_plan"]["decisions"][0]["name"] == "voc_pca_descriptors"
    np.testing.assert_array_equal(cached["test_scores"], pvoc.main(small)["test_scores"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pvoc.main(base)


@pytest.fixture(scope="module")
def jax_fit():
    """A VOCSIFTFisher state fitted by the JAX package on 12 small images
    (f32 SIFT step 6, PCA to 16, an 8-component GMM, λ 0.05)."""
    rng = np.random.default_rng(3)
    classes = [i % 4 for i in range(12)]
    images = [_class_image(rng, c, size=56)[:, :, ::-1].astype(np.float32) for c in classes]
    batch = jnp.asarray(np.stack(images))
    sift = JaxSIFT(6, scale_step=0)
    descs = jax.jit(lambda b: sift(jfv.grayscale(b)))(batch)
    buckets = {(56, 56): (np.arange(12), descs)}
    pca_mat = jax_pca(jfv.sample_columns(buckets, 6000, 42).T, 16)
    pca_desc = JaxBatchPCA(pca_mat)(descs)
    gmm = JaxGMMEstimator(8, max_iter=20).fit(
        jfv.sample_columns({(56, 56): (np.arange(12), pca_desc)}, 6000, 43).T
    )
    features = jfv.fisher_feature_pipeline(gmm)(pca_desc)
    labels = jutil.ClassLabelIndicatorsFromIntArrayLabels(20)([[c] for c in classes])
    model = JaxBLS(4096, 1, 0.05).fit(features, labels, num_features=features.shape[1])
    arrays = dict(
        pca_mat=np.asarray(pca_mat), gmm_means=np.asarray(gmm.means),
        gmm_variances=np.asarray(gmm.variances), gmm_weights=np.asarray(gmm.weights),
        model_xs=[np.asarray(x) for x in model.xs], model_b=np.asarray(model.b),
        model_block_means=[np.asarray(s.mean) for s in model.feature_scalers],
    )
    return arrays, np.asarray(descs), np.asarray(features), np.asarray(model(features))


def _within_f32_floor(port, jax_side, exact):
    bar = 1e-2 * np.abs(exact).max()
    assert np.abs(port - exact).max() <= bar
    assert np.abs(jax_side - exact).max() <= bar


def test_carried_over_state_matches_jax(jax_fit):
    arrays, descs, jax_features, jax_scores = jax_fit
    fitted = convert.voc_from_arrays(**arrays, sift_step_size=6, scale_step=0, device="cpu")
    pca_desc = fitted.pca(torch.from_numpy(descs.copy()))
    gmm = [arrays[k] for k in ("gmm_means", "gmm_variances", "gmm_weights")]

    # The sufficient statistics, against JAX's from the same descriptors.
    g = fitted.gmm
    port_stats = fs.fv_stats(pca_desc, None, g.means, g.variances, g.weights)
    for i, mat in enumerate(pca_desc.numpy()):
        x = jnp.asarray(mat.T)
        q = jax.nn.softmax(jax_log_resp(x, *gmm), axis=-1)
        for got, want in zip(port_stats, (q.sum(axis=0), x.T @ q, (x * x).T @ q)):
            want = np.asarray(want)
            np.testing.assert_allclose(got[i].numpy(), want, rtol=2e-4, atol=2e-5 * np.abs(want).max())

    # Fisher vectors, features and scores, against the f64 chain.
    gmm64 = [torch.from_numpy(a).double() for a in gmm]
    exact = torch.stack([fisher_vector(m.T, *gmm64) for m in pca_desc.double()])
    jax_fv = np.asarray(JaxFisherVector(JaxGMM(*gmm))(jnp.asarray(pca_desc.numpy())))
    _within_f32_floor(FisherVector(fitted.gmm)(pca_desc).numpy(), jax_fv, exact.numpy())
    for node in pfv.fisher_feature_pipeline(GaussianMixtureModel(*gmm64)).nodes[1:]:
        exact = node(exact)
    features = pfv.fisher_feature_pipeline(fitted.gmm)(pca_desc)
    _within_f32_floor(features.numpy(), jax_features, exact.numpy())
    exact_model = convert.voc_from_arrays(**arrays, device="cpu").model
    exact_model.xs = [x.double() for x in exact_model.xs]
    exact_model.b = exact_model.b.double()
    for scaler in exact_model.feature_scalers:
        scaler.mean = scaler.mean.double()
    _within_f32_floor(fitted.model(features).numpy(), jax_scores, exact_model(exact).numpy())

    round_trip = convert.voc_to_arrays(fitted.servable)
    assert (round_trip["sift_step_size"], round_trip["scale_step"]) == (6, 0)
    for key in ("pca_mat", "gmm_means", "gmm_variances", "gmm_weights", "model_b"):
        np.testing.assert_array_equal(round_trip[key], arrays[key])


@pytest.mark.parametrize("seed", [0, 1])
def test_map_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    n, c = 40, 6
    scores = np.round(rng.normal(size=(n, c)), 1)  # ties included
    labels = [list(rng.choice(c - 1, size=rng.integers(1, 3), replace=False)) for _ in range(n)]
    labels[0] = np.array([2, -1])  # padded label array
    got = mean_average_precision(labels, scores, c)
    np.testing.assert_array_equal(got, jax_map(labels, scores, c))
    assert got[c - 1] == 0.0  # a class with no positives


def test_voc_loader_matches_jax(voc_tar):
    tar, labels = voc_tar
    got, ref = ploaders.voc_loader(tar, labels), jax_voc_loader(tar, labels)
    assert got.filenames == ref.filenames and got.labels == ref.labels
    for a, b in zip(got.images, ref.images):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).mean() <= 1.0  # PIL against libjpeg: IDCT rounding


def test_decode_image_rejects_small_and_corrupt():
    import io

    from PIL import Image

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    assert ploaders.decode_image(png(np.zeros((20, 50, 3), np.uint8))) is None
    assert ploaders.decode_image(b"not an image") is None
    gray = ploaders.decode_image(png(np.full((40, 40), 7, np.uint8)))
    assert gray.shape == (40, 40, 3) and np.all(gray == 7)
    rgb = np.zeros((40, 40, 3), np.uint8)
    rgb[..., 0] = 200  # red
    assert np.all(ploaders.decode_image(png(rgb))[..., 2] == 200)  # BGR


@pytest.mark.parametrize("channels", [3, 1, 4])
def test_grayscale_nodes_match_jax(rng, channels):
    x = rng.uniform(0, 255, (2, 9, 11, channels)).astype(np.float32)
    ref = np.asarray(jimages.GrayScaler()(jimages.PixelScaler()(jnp.asarray(x))))
    got = pimages.GrayScaler()(pimages.PixelScaler()(torch.from_numpy(x))).numpy()
    assert got.shape == ref.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_row_nodes_match_jax(rng):
    x = rng.normal(size=(4, 6, 5)).astype(np.float32)
    x[1] = 0.0
    flat = np.asarray(jutil.MatrixVectorizer()(jnp.asarray(x)))
    np.testing.assert_array_equal(putil.MatrixVectorizer()(torch.from_numpy(x)).numpy(), flat)
    for jnode, pnode in ((jstats.NormalizeRows(), pstats.NormalizeRows()),
                         (jstats.SignedHellingerMapper(), pstats.SignedHellingerMapper())):
        np.testing.assert_allclose(pnode(torch.from_numpy(flat)).numpy(),
                                   np.asarray(jnode(jnp.asarray(flat))), rtol=1e-6, atol=1e-7)


def test_label_indicators_match_jax():
    labels = [[0, 3], [2], np.array([1, -1]), [19]]
    got = putil.ClassLabelIndicatorsFromIntArrayLabels(20)(labels).numpy()
    np.testing.assert_array_equal(got, np.asarray(jutil.ClassLabelIndicatorsFromIntArrayLabels(20)(labels)))
    with pytest.raises(ValueError):
        putil.ClassLabelIndicatorsFromIntArrayLabels(1)
