"""Checkpoints in the port (``keystone_tpu_torch.core.checkpoint``,
counterpart of ``tests/test_checkpoint.py``) and across the two packages,
which share one on-disk format.

* Port round trips: every fitted node kind, composed pipelines and a dict
  bundle survive save/load with bit-identical tensors and identical
  outputs, also in a fresh interpreter; the manifest contract (version,
  corrupt shapes, mixed pairs, unserializable nodes) is enforced.
* The node registry: every class the JAX package registers (but
  ``Cacher``) has a port twin of the same name and fields.
* Across packages, per node kind: a JAX checkpoint loads in the port and a
  port checkpoint loads in the JAX package, and both apply alike on the
  same input within the tolerance that node's parity test pins (stated
  per case below).  A checkpoint the JAX package wrote sharded over a
  mesh raises ``CheckpointMismatch`` in the port, unless loaded with
  ``mesh=`` (``tests/test_torch_checkpoint_mesh.py`` holds that load).
* End to end through ``--pipelineFile``: RandomPatchCifar and
  MnistRandomFFT give equal predictions and VOCSIFTFisher the same MAP
  whichever package fitted and whichever restored; a restored port run
  reads no training data."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keystone_tpu.core import checkpoint as jck
from keystone_tpu.core import pipeline as jpipe
from keystone_tpu.ops import conv_fused as jconv
from keystone_tpu.ops import daisy as jdaisy
from keystone_tpu.ops import fisher as jfisher
from keystone_tpu.ops import hog as jhog
from keystone_tpu.ops import images as jimages
from keystone_tpu.ops import lcs as jlcs
from keystone_tpu.ops import sift as jsift
from keystone_tpu.ops import stats as jstats
from keystone_tpu.ops import util as jutil
from keystone_tpu.solvers import block as jblock
from keystone_tpu.solvers import gmm as jgmm
from keystone_tpu.solvers import linear as jlinear
from keystone_tpu.solvers import naive_bayes as jnb
from keystone_tpu.solvers import pca as jpca
from keystone_tpu.solvers import whitening as jwhite
from keystone_tpu.workloads import cifar_random_patch as jax_cifar
from keystone_tpu.workloads import mnist_random_fft as jax_mnist
from keystone_tpu.workloads import voc_sift_fisher as jax_voc
from keystone_tpu_torch.core import checkpoint as ck
from keystone_tpu_torch.core.checkpoint import (
    CheckpointError,
    CheckpointMismatch,
    checkpoint_exists,
    load_numerics_baseline,
    load_or_fit,
    load_pipeline,
    save_pipeline,
)
from keystone_tpu_torch.core.pipeline import NODE_REGISTRY, Pipeline, transformer
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.fisher import FisherVector
from keystone_tpu_torch.ops.stats import (
    CosineRandomFeatures,
    NormalizeRows,
    RandomSignNode,
    SignedHellingerMapper,
    StandardScaler,
    StandardScalerModel,
)
from keystone_tpu_torch.ops.util import MatrixVectorizer
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from keystone_tpu_torch.solvers.linear import LinearMapEstimator, LinearMapper
from keystone_tpu_torch.solvers.naive_bayes import NaiveBayesEstimator
from keystone_tpu_torch.solvers.pca import BatchPCATransformer, PCAEstimator, PCATransformer
from keystone_tpu_torch.solvers.whitening import ZCAWhitenerEstimator
from keystone_tpu_torch.workloads import cifar_random_patch as pt_cifar
from keystone_tpu_torch.workloads import mnist_random_fft as pt_mnist
from keystone_tpu_torch.workloads import voc_sift_fisher as pt_voc
from test_fisher_pipelines import write_voc_tar
from test_torch_cifar_random_patch import FLAGS as CIFAR_FLAGS
from test_torch_cifar_random_patch import _write_cifar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _leaves(obj) -> list:
    """Tensor leaves of a port object in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _leaves(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _leaves(obj[k])]
    if isinstance(obj, Pipeline):
        return _leaves(list(obj.nodes))
    if type(obj).__name__ == "BlockLinearMapper":
        return _leaves([obj.xs, obj.b, obj.feature_scalers])
    entry = NODE_REGISTRY.get(type(obj).__name__)
    if entry is None:
        return []
    return _leaves([getattr(obj, f) for f in entry[1] + entry[2]])


def _assert_leaves_bit_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _np(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.float().numpy() if out.dtype == torch.bfloat16 else out.numpy()
    return np.asarray(out, np.float32) if np.asarray(out).dtype.name == "bfloat16" else np.asarray(out)


def _roundtrip(tmp_path, node, batch, idx=0):
    stem = str(tmp_path / f"ck_{idx}")
    save_pipeline(stem, node)
    loaded = load_pipeline(stem, device="cpu")
    assert type(loaded) is type(node)
    _assert_leaves_bit_identical(node, loaded)
    assert np.array_equal(_np(node(batch)), _np(loaded(batch)))
    return loaded


# -- port round trips ---------------------------------------------------------------


def _t(a):
    return torch.from_numpy(a)


PORT_NODES = {
    "block_linear_mapper": lambda rng: (
        BlockLeastSquaresEstimator(4, 2, 0.1).fit(_t(_f32(rng, 24, 10)), _t(_f32(rng, 24, 3))),
        _t(_f32(rng, 24, 10))),
    "pca": lambda rng: (PCAEstimator(5).fit(_t(_f32(rng, 50, 12))), _t(_f32(rng, 50, 12))),
    "batch_pca": lambda rng: (BatchPCATransformer(_t(_f32(rng, 12, 5))), _t(_f32(rng, 3, 12, 7))),
    "zca": lambda rng: (ZCAWhitenerEstimator().fit(_t(_f32(rng, 40, 9))), _t(_f32(rng, 40, 9))),
    "gmm": lambda rng: (GaussianMixtureModelEstimator(4, max_iter=5).fit(_t(_f32(rng, 120, 6))),
                        _t(_f32(rng, 120, 6))),
    "naive_bayes": lambda rng: (
        NaiveBayesEstimator(3, device="cpu").fit(
            _t(rng.integers(0, 5, (30, 11)).astype(np.float32)), _t(rng.integers(0, 3, 30))),
        _t(rng.integers(0, 5, (30, 11)).astype(np.float32))),
    "standard_scaler": lambda rng: (StandardScaler().fit(_t(_f32(rng, 25, 7))), _t(_f32(rng, 25, 7))),
    "linear_mapper_with_nested_scaler": lambda rng: (
        LinearMapEstimator(lam=0.2).fit(_t(_f32(rng, 30, 6)), _t(_f32(rng, 30, 2))),
        _t(_f32(rng, 30, 6))),
    "fisher_vector_nests_gmm": lambda rng: (
        FisherVector(GaussianMixtureModel(_t(_f32(rng, 5, 3)), _t(np.abs(_f32(rng, 5, 3)) + 0.5),
                                          _t(np.full(3, 1 / 3, np.float32)))),
        _t(_f32(rng, 2, 5, 9))),
    "cosine_random_features": lambda rng: (
        CosineRandomFeatures.create(6, 16, 0.5, torch.Generator().manual_seed(0)),
        _t(_f32(rng, 4, 6))),
    "random_sign_node": lambda rng: (
        RandomSignNode.create(10, torch.Generator().manual_seed(1), device="cpu"),
        _t(_f32(rng, 3, 10))),
}


@pytest.mark.parametrize("kind", sorted(PORT_NODES))
def test_node_roundtrip(kind, tmp_path, rng):
    node, batch = PORT_NODES[kind](rng)
    loaded = _roundtrip(tmp_path, node, batch)
    if kind == "linear_mapper_with_nested_scaler":
        assert isinstance(loaded.feature_scaler, StandardScalerModel)


class TestPipelineRoundtrips:
    def test_composed_pipeline(self, tmp_path, rng):
        scaler = StandardScalerModel(_t(_f32(rng, 8)), _t(np.abs(_f32(rng, 8)) + 0.5))
        pca = PCATransformer(_t(_f32(rng, 8, 4)))
        pipe = scaler >> pca >> NormalizeRows()
        loaded = _roundtrip(tmp_path, pipe, _t(_f32(rng, 5, 8)))
        assert [type(n).__name__ for n in loaded.nodes] == [
            "StandardScalerModel", "PCATransformer", "NormalizeRows"]

    def test_voc_style_fisher_pipeline(self, tmp_path, rng):
        desc_dim, vocab = 6, 4
        gmm = GaussianMixtureModelEstimator(vocab, max_iter=4).fit(_t(_f32(rng, 200, desc_dim)))
        model = BlockLeastSquaresEstimator(16, 1, 0.1).fit(
            _t(_f32(rng, 20, 2 * desc_dim * vocab)), _t(_f32(rng, 20, 3)))
        pipe = Pipeline([BatchPCATransformer(_t(_f32(rng, 16, desc_dim))), FisherVector(gmm),
                         MatrixVectorizer(), NormalizeRows(), SignedHellingerMapper(),
                         NormalizeRows(), model])
        _roundtrip(tmp_path, pipe, _t(_f32(rng, 7, 16, 30)))

    def test_dict_bundle(self, tmp_path, rng):
        pca = PCATransformer(_t(_f32(rng, 6, 3)))
        gmm = GaussianMixtureModel(_t(_f32(rng, 3, 2)), _t(np.abs(_f32(rng, 3, 2)) + 1),
                                   _t(np.full(2, 0.5, np.float32)))
        stem = str(tmp_path / "bundle")
        save_pipeline(stem, {"pca": pca, "gmm": gmm})
        loaded = load_pipeline(stem, device="cpu")
        assert set(loaded) == {"pca", "gmm"}
        _assert_leaves_bit_identical(pca, loaded["pca"])
        _assert_leaves_bit_identical(gmm, loaded["gmm"])


class TestCheckpointContract:
    def test_load_or_fit_fits_then_loads(self, tmp_path, rng):
        x = _t(_f32(rng, 20, 8))
        stem = str(tmp_path / "lof")
        calls = []

        class CountingPCA(PCAEstimator):
            def fit(self, samples):
                calls.append(1)
                return super().fit(samples)

        est = CountingPCA(3)
        first = load_or_fit(stem, est, x, device="cpu")
        assert checkpoint_exists(stem) and len(calls) == 1
        second = load_or_fit(stem, est, x, device="cpu")
        assert len(calls) == 1  # loaded, not refit
        _assert_leaves_bit_identical(first, second)

    def test_function_transformer_is_rejected(self, tmp_path):
        with pytest.raises(CheckpointError, match="FunctionTransformer"):
            save_pipeline(str(tmp_path / "bad"), transformer(lambda b: b * 2))

    def _edit(self, stem, edit):
        with open(stem + ".json") as fh:
            manifest = json.load(fh)
        edit(manifest)
        with open(stem + ".json", "w") as fh:
            json.dump(manifest, fh)

    def test_corrupt_manifest_rejected(self, tmp_path, rng):
        stem = save_pipeline(str(tmp_path / "ck"), PCATransformer(_t(_f32(rng, 4, 2))))
        self._edit(stem, lambda m: m["arrays"]["a0"].update(shape=[9, 9]))
        with pytest.raises(CheckpointError, match="corrupt|schema"):
            load_pipeline(stem, device="cpu")

    def test_version_mismatch_rejected(self, tmp_path, rng):
        stem = save_pipeline(str(tmp_path / "ck"), PCATransformer(_t(_f32(rng, 4, 2))))
        self._edit(stem, lambda m: m.update(version=99))
        with pytest.raises(CheckpointError, match="version"):
            load_pipeline(stem, device="cpu")

    def test_mixed_pair_rejected(self, tmp_path, rng):
        a = save_pipeline(str(tmp_path / "a"), PCATransformer(_t(_f32(rng, 4, 2))))
        b = save_pipeline(str(tmp_path / "b"), PCATransformer(_t(_f32(rng, 4, 2))))
        os.replace(b + ".npz", a + ".npz")
        with pytest.raises(CheckpointError, match="hash"):
            load_pipeline(a, device="cpu")

    def test_bfloat16_leaves_roundtrip(self, tmp_path, rng):
        node = PCATransformer(_t(_f32(rng, 6, 3)).to(torch.bfloat16))
        stem = save_pipeline(str(tmp_path / "bf16"), node)
        loaded = load_pipeline(stem, device="cpu")
        assert loaded.pca_mat.dtype == torch.bfloat16
        _assert_leaves_bit_identical(node, loaded)

    def test_numerics_baseline_rides_the_manifest(self, tmp_path, rng):
        stem = save_pipeline(str(tmp_path / "nb"), PCATransformer(_t(_f32(rng, 4, 2))),
                             numerics_baseline={"kind": "class_histogram", "observed": 3})
        assert load_numerics_baseline(stem) == {"kind": "class_histogram", "observed": 3}
        assert load_numerics_baseline(str(tmp_path / "missing")) is None

    def test_cuda_load_without_a_card_raises(self, tmp_path, rng, monkeypatch):
        stem = save_pipeline(str(tmp_path / "dev"), PCATransformer(_t(_f32(rng, 4, 2))))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            load_pipeline(stem)


class TestTopology:
    def test_port_save_records_one_replicated_device(self, tmp_path, rng):
        stem = save_pipeline(str(tmp_path / "topo"), PCATransformer(_t(_f32(rng, 4, 2))))
        with open(stem + ".json") as fh:
            manifest = json.load(fh)
        assert manifest["format"] == ck.FORMAT_NAME and manifest["version"] == 1
        assert manifest["all_replicated"] is True and manifest["topology"]["mesh"] is None

    def test_replicated_checkpoint_loads_across_topologies(self, tmp_path, rng):
        node = PCATransformer(_t(_f32(rng, 4, 2)))
        stem = save_pipeline(str(tmp_path / "portable"), node)
        TestCheckpointContract()._edit(stem, lambda m: m["topology"].update(
            device_count=1024, platform="tpu"))
        _assert_leaves_bit_identical(node, load_pipeline(stem, device="cpu"))

    def test_pre_guard_manifest_still_loads(self, tmp_path, rng):
        node = PCATransformer(_t(_f32(rng, 4, 2)))
        stem = save_pipeline(str(tmp_path / "old"), node)

        def drop(m):
            del m["topology"], m["all_replicated"]

        TestCheckpointContract()._edit(stem, drop)
        _assert_leaves_bit_identical(node, load_pipeline(stem, device="cpu"))

    def test_sharded_jax_checkpoint_raises_mismatch(self, tmp_path, rng, mesh8):
        """The naive load is refused; with ``mesh=`` the rows are laid out
        on the port's slots, bit-equal to what the JAX package saved."""
        from keystone_tpu.parallel.mesh import row_sharding, use_mesh
        from keystone_tpu_torch.parallel.mesh import ShardedRows, make_mesh

        arr = _f32(rng, 16, 2)
        node = jpca.PCATransformer(jax.device_put(jnp.asarray(arr), row_sharding(mesh8)))
        with use_mesh(mesh8):
            stem = jck.save_pipeline(str(tmp_path / "sharded"), node)
        with pytest.raises(CheckpointMismatch, match="sharded"):
            load_pipeline(stem, device="cpu")
        assert issubclass(CheckpointMismatch, CheckpointError)
        placed = load_pipeline(stem, mesh=make_mesh(4, 1, devices=[torch.device("cpu")] * 4))
        assert isinstance(placed.pca_mat, ShardedRows)
        assert torch.equal(placed.pca_mat.gather(), torch.from_numpy(arr))


def test_predictions_identical_in_fresh_process(tmp_path, rng):
    """fit -> save -> reload in a new interpreter -> identical scores."""
    x = _t(_f32(rng, 24, 10))
    scaler = StandardScaler().fit(x)
    model = BlockLeastSquaresEstimator(4, 2, 0.1).fit(scaler(x), _t(_f32(rng, 24, 3)))
    pipe = Pipeline([scaler, model])
    stem = save_pipeline(str(tmp_path / "fresh"), pipe)
    np.save(tmp_path / "input.npy", x.numpy())
    np.save(tmp_path / "expected.npy", pipe(x).numpy())
    script = (
        "import numpy as np, torch\n"
        "from keystone_tpu_torch.core.checkpoint import load_pipeline\n"
        f"pipe = load_pipeline({stem!r}, device='cpu')\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'input.npy')!r}))\n"
        f"expected = np.load({str(tmp_path / 'expected.npy')!r})\n"
        "np.testing.assert_array_equal(pipe(x).numpy(), expected)\n"
        "print('FRESH_PROCESS_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, env=env, cwd=_REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FRESH_PROCESS_OK" in res.stdout


# -- the registry ---------------------------------------------------------------------


def test_every_jax_node_has_a_port_twin():
    jck._ensure_standard_registry()
    ck._ensure_standard_registry()
    jax_names = set(jpipe.NODE_REGISTRY) - {"Cacher"}
    assert jax_names <= set(NODE_REGISTRY), sorted(jax_names - set(NODE_REGISTRY))
    for name in sorted(jax_names):
        _, jdata, jmeta = jpipe.NODE_REGISTRY[name]
        _, pdata, pmeta = NODE_REGISTRY[name]
        assert (pdata, pmeta) == (jdata, jmeta), name


# -- across packages, per node kind ----------------------------------------------------

EXACT = dict(rtol=0, atol=0)


def _fft_chain(rng):
    return jpipe.Pipeline([jstats.RandomSignNode(jnp.asarray(np.sign(_f32(rng, 16)) + 0.0)),
                           jstats.PaddedFFT(), jstats.LinearRectifier(0.0)])


def _jax_block_model(rng):
    return jblock.BlockLeastSquaresEstimator(4, 2, 0.1).fit(
        jnp.asarray(_f32(rng, 24, 10)), jnp.asarray(_f32(rng, 24, 3)))


def _jax_gmm(rng):
    return jgmm.GaussianMixtureModel(_f32(rng, 5, 3), np.abs(_f32(rng, 5, 3)) + 0.5,
                                     np.full(3, 1 / 3, np.float32))


def _filters(rng, f, ws, c):
    return _f32(rng, f, ws * ws * c)


#: kind -> (build(rng) -> (JAX node, input), tolerance of the node's parity test).
#: An input whose relative tolerance carries "max" scales atol by the output's max.
CASES = {
    "StandardScalerModel": (lambda rng: (jstats.StandardScalerModel(
        jnp.asarray(_f32(rng, 8)), jnp.asarray(np.abs(_f32(rng, 8)) + 0.5)), _f32(rng, 5, 8)),
        dict(rtol=1e-5, atol=1e-6)),
    "CosineRandomFeatures": (lambda rng: (jstats.CosineRandomFeatures(
        jnp.asarray(_f32(rng, 16, 6)), jnp.asarray(_f32(rng, 16))), _f32(rng, 4, 6)),
        dict(rtol=1e-5, atol=1e-5)),
    "PaddedFFT": (lambda rng: (jstats.PaddedFFT(), _f32(rng, 3, 10)), dict(rtol=1e-5, atol=1e-5)),
    "RandomSignNode": (lambda rng: (jstats.RandomSignNode(
        jnp.asarray(np.sign(_f32(rng, 10)) + 0.0)), _f32(rng, 3, 10)), EXACT),
    "LinearRectifier": (lambda rng: (jstats.LinearRectifier(0.1, 0.2), _f32(rng, 3, 7)), EXACT),
    "NormalizeRows": (lambda rng: (jstats.NormalizeRows(), _f32(rng, 4, 6)),
                      dict(rtol=1e-6, atol=1e-7)),
    "SignedHellingerMapper": (lambda rng: (jstats.SignedHellingerMapper(), _f32(rng, 4, 6)),
                              dict(rtol=1e-6, atol=1e-7)),
    "PixelScaler": (lambda rng: (jimages.PixelScaler(), _f32(rng, 2, 4, 4, 3, scale=80.0)),
                    dict(rtol=1e-6, atol=1e-7)),
    "GrayScaler": (lambda rng: (jimages.GrayScaler(), _f32(rng, 2, 4, 4, 3, scale=80.0)),
                   dict(rtol=1e-6, atol=1e-6 * 255)),
    "ImageVectorizer": (lambda rng: (jimages.ImageVectorizer(), _f32(rng, 2, 4, 4, 3)), EXACT),
    "SymmetricRectifier": (lambda rng: (jimages.SymmetricRectifier(0.0, 0.25),
                                        _f32(rng, 2, 4, 4, 3)), EXACT),
    "Pooler": (lambda rng: (jimages.Pooler(3, 4, None, "sum"), _f32(rng, 2, 10, 10, 2)),
               dict(rtol=1e-5, atol=1e-6)),
    "Convolver": (lambda rng: (jimages.Convolver(
        _filters(rng, 4, 3, 2), _f32(rng, 18), img_channels=2),
        rng.uniform(0, 255, (2, 8, 8, 2)).astype(np.float32)), dict(rtol=1e-5, atol_max=1e-5)),
    "FusedConvFeaturizer": (lambda rng: (jconv.FusedConvFeaturizer(
        _filters(rng, 8, 6, 3), _f32(rng, 108), pool_stride=3, pool_size=4, alpha=0.25,
        img_channels=3), rng.uniform(0, 255, (2, 12, 12, 3)).astype(np.float32)),
        dict(rtol=0, atol_max=1e-2)),
    "FusedConvFeaturizer_f32": (lambda rng: (jconv.FusedConvFeaturizer(
        _filters(rng, 8, 6, 3), _f32(rng, 108), pool_stride=3, pool_size=4, alpha=0.25,
        img_channels=3, activation_dtype=jnp.float32),
        rng.uniform(0, 255, (2, 12, 12, 3)).astype(np.float32)), dict(rtol=2e-5, atol_max=2e-5)),
    "ImageExtractor": (lambda rng: (jimages.ImageExtractor(), types.SimpleNamespace(
        images=_f32(rng, 2, 3, 3, 1), labels=np.arange(2))), EXACT),
    "LabelExtractor": (lambda rng: (jimages.LabelExtractor(), types.SimpleNamespace(
        images=_f32(rng, 2, 3, 3, 1), labels=np.arange(2, dtype=np.int32))), EXACT),
    "ClassLabelIndicatorsFromIntLabels": (lambda rng: (
        jutil.ClassLabelIndicatorsFromIntLabels(5), np.array([0, 4, 2, 2], np.int32)), EXACT),
    "ClassLabelIndicatorsFromIntArrayLabels": (lambda rng: (
        jutil.ClassLabelIndicatorsFromIntArrayLabels(5),
        np.array([[0, 2], [1, -1], [4, 3]], np.int32)), EXACT),
    "MaxClassifier": (lambda rng: (jutil.MaxClassifier(), _f32(rng, 4, 5)), EXACT),
    "TopKClassifier": (lambda rng: (jutil.TopKClassifier(2), _f32(rng, 4, 5)), EXACT),
    "Cast": (lambda rng: (jutil.Cast(jnp.bfloat16), _f32(rng, 3, 4)), EXACT),
    "MatrixVectorizer": (lambda rng: (jutil.MatrixVectorizer(), _f32(rng, 2, 3, 4)), EXACT),
    "GroupConcatFeaturizer": (lambda rng: (jutil.GroupConcatFeaturizer(
        [[_fft_chain(rng), _fft_chain(rng)], [_fft_chain(rng)]]), _f32(rng, 3, 16)),
        dict(rtol=1e-5, atol=1e-5)),
    "FisherVector": (lambda rng: (jfisher.FisherVector(_jax_gmm(rng)), _f32(rng, 2, 5, 9)),
                     dict(rtol=2e-4, atol=2e-5)),
    "HogExtractor": (lambda rng: (jhog.HogExtractor(4), rng.uniform(
        0, 1, (1, 20, 20, 3)).astype(np.float32)), dict(rtol=0, atol=1e-6)),
    "DaisyExtractor": (lambda rng: (jdaisy.DaisyExtractor(pixel_border=16, stride=8),
                                    rng.uniform(0, 1, (1, 40, 40, 1)).astype(np.float32)),
                       dict(rtol=0, atol=1e-6)),
    "LCSExtractor": (lambda rng: (jlcs.LCSExtractor(4, 16, 6), rng.uniform(
        0, 255, (1, 40, 40, 3)).astype(np.float32)), dict(rtol=1e-5, atol=255e-6)),
    "SIFTExtractor": (lambda rng: (jsift.SIFTExtractor(compute_dtype=jnp.bfloat16),
                                   rng.uniform(0, 1, (1, 32, 32)).astype(np.float32)),
                      dict(sift=True)),
    "NaiveBayesModel": (lambda rng: (jnb.NaiveBayesModel(
        jnp.asarray(_f32(rng, 3)), jnp.asarray(_f32(rng, 3, 11))), _f32(rng, 4, 11)),
        dict(rtol=1e-5, atol=1e-5)),
    "PCATransformer": (lambda rng: (jpca.PCATransformer(jnp.asarray(_f32(rng, 8, 4))),
                                    _f32(rng, 5, 8)), dict(rtol=1e-5, atol=1e-6)),
    "BatchPCATransformer": (lambda rng: (jpca.BatchPCATransformer(jnp.asarray(_f32(rng, 12, 5))),
                                         _f32(rng, 3, 12, 7)), dict(rtol=1e-5, atol=1e-6)),
    "GaussianMixtureModel": (lambda rng: (_jax_gmm(rng), _f32(rng, 6, 5)),
                             dict(rtol=1e-5, atol=1e-5)),
    "LinearMapper": (lambda rng: (jlinear.LinearMapper(
        jnp.asarray(_f32(rng, 6, 2)), jnp.asarray(_f32(rng, 2)), jstats.StandardScalerModel(
            jnp.asarray(_f32(rng, 6)), jnp.asarray(np.abs(_f32(rng, 6)) + 0.5))),
        _f32(rng, 4, 6)), dict(rtol=1e-5, atol_max=1e-6)),
    "LeastSquaresModel": (lambda rng: (jlinear.LeastSquaresModel(
        jnp.asarray(_f32(rng, 6, 2)), jnp.asarray(_f32(rng, 2))), _f32(rng, 4, 6)),
        dict(rtol=1e-5, atol_max=1e-6)),
    "ZCAWhitener": (lambda rng: (jwhite.ZCAWhitener(jnp.asarray(_f32(rng, 9, 9)),
                                                    jnp.asarray(_f32(rng, 9))), _f32(rng, 5, 9)),
                    dict(rtol=1e-4, atol=1e-4)),
    "Identity": (lambda rng: (jpipe.Identity(), _f32(rng, 3, 4)), EXACT),
    "BlockLinearMapper": (lambda rng: (_jax_block_model(rng), _f32(rng, 24, 10)),
                          dict(rtol=1e-5, atol_max=1e-6)),
}


def _port_input(x):
    if isinstance(x, types.SimpleNamespace):
        return x
    return torch.from_numpy(x)


def _jax_input(x):
    return x if isinstance(x, types.SimpleNamespace) else jnp.asarray(x)


def _assert_close(got, want, tol):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    if tol.get("sift"):
        # SIFT's bar: quantised entries within ±1 on at least 99.5 %.
        assert np.mean(np.abs(got - want) <= 1.0) >= 0.995
        return
    atol = tol.get("atol", 0.0) + tol.get("atol_max", 0.0) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_jax_checkpoint_loads_in_port(kind, tmp_path, rng):
    build, tol = CASES[kind]
    jnode, x = build(rng)
    stem = jck.save_pipeline(str(tmp_path / "jax"), jnode)
    pnode = load_pipeline(stem, device="cpu")
    assert type(pnode).__name__ == kind.split("_f32")[0]
    _assert_close(pnode(_port_input(x)), jnode(_jax_input(x)), tol)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_checkpoint_loads_in_jax(kind, tmp_path, rng):
    build, tol = CASES[kind]
    jnode, x = build(rng)
    pnode = load_pipeline(jck.save_pipeline(str(tmp_path / "jax"), jnode), device="cpu")
    stem = save_pipeline(str(tmp_path / "port"), pnode)
    jback = jck.load_pipeline(stem)
    assert type(jback).__name__ == kind.split("_f32")[0]
    _assert_close(jback(_jax_input(x)), pnode(_port_input(x)), tol)


# -- end to end through --pipelineFile --------------------------------------------------


@pytest.fixture(scope="module")
def cifar_files(tmp_path_factory):
    """The separable set of ``test_torch_cifar_random_patch.py``: 400 train
    / 150 test images, 4 classes, palette shared between splits."""
    rng = np.random.default_rng(5)
    base = rng.uniform(40, 215, (4, 3))
    d = tmp_path_factory.mktemp("cifar")
    train, test = str(d / "train.bin"), str(d / "test.bin")
    _write_cifar(train, 400, rng, base)
    _write_cifar(test, 150, rng, base)
    return train, test


def test_cifar_pipeline_file_across_packages(cifar_files, tmp_path, monkeypatch):
    train, test = cifar_files
    jres = jax_cifar.main(["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS,
                           "--pipelineFile", str(tmp_path / "jax")])
    monkeypatch.setattr(rp, "launches", 0)
    restored = pt_cifar.main(["--trainLocation", str(tmp_path / "absent.bin"),
                              "--testLocation", test, *CIFAR_FLAGS, "--device", "cpu",
                              "--pipelineFile", str(tmp_path / "jax")])
    assert restored["restored"] is True
    np.testing.assert_array_equal(restored["test_predictions"], jres["test_predictions"])

    fitted = pt_cifar.main(["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS,
                            "--device", "cpu", "--pipelineFile", str(tmp_path / "port")])
    assert load_numerics_baseline(str(tmp_path / "port"))["kind"] == "class_histogram"
    again = pt_cifar.main(["--trainLocation", str(tmp_path / "absent.bin"),
                           "--testLocation", test, *CIFAR_FLAGS, "--device", "cpu",
                           "--pipelineFile", str(tmp_path / "port")])
    np.testing.assert_array_equal(again["test_predictions"], fitted["test_predictions"])
    jback = jax_cifar.main(["--trainLocation", train, "--testLocation", test, *CIFAR_FLAGS,
                            "--pipelineFile", str(tmp_path / "port")])
    assert jback["restored"] is True
    np.testing.assert_array_equal(jback["test_predictions"], fitted["test_predictions"])


@pytest.fixture(scope="module")
def mnist_csvs(tmp_path_factory):
    """The CSVs of ``test_torch_mnist_random_fft.py``: 784-pixel rows, 10
    classes, centres shared between 600 train and 200 test rows."""
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 1.0, (10, 784))

    def make(n):
        labels = rng.integers(1, 11, n)
        return np.column_stack([labels, centers[labels - 1] + 0.3 * rng.normal(size=(n, 784))])

    d = tmp_path_factory.mktemp("mnist")
    train, test = str(d / "train.csv"), str(d / "test.csv")
    np.savetxt(train, make(600), delimiter=",", fmt="%.5f")
    np.savetxt(test, make(200), delimiter=",", fmt="%.5f")
    return train, test


MNIST_FLAGS = ["--numFFTs", "4", "--blockSize", "512", "--lambda", "10"]


def test_mnist_pipeline_file_across_packages(mnist_csvs, tmp_path):
    train, test = mnist_csvs
    jres = jax_mnist.main(["--trainLocation", train, "--testLocation", test, *MNIST_FLAGS,
                           "--pipelineFile", str(tmp_path / "jax")])
    restored = pt_mnist.main(["--trainLocation", str(tmp_path / "absent.csv"),
                              "--testLocation", test, *MNIST_FLAGS, "--device", "cpu",
                              "--pipelineFile", str(tmp_path / "jax")])
    assert restored["restored"] is True and restored["test_error"] == 0.0
    np.testing.assert_array_equal(restored["test_predictions"], jres["test_predictions"])

    fitted = pt_mnist.main(["--trainLocation", train, "--testLocation", test, *MNIST_FLAGS,
                            "--device", "cpu", "--pipelineFile", str(tmp_path / "port")])
    again = pt_mnist.main(["--trainLocation", str(tmp_path / "absent.csv"),
                           "--testLocation", test, *MNIST_FLAGS, "--device", "cpu",
                           "--pipelineFile", str(tmp_path / "port")])
    np.testing.assert_array_equal(again["test_predictions"], fitted["test_predictions"])
    jback = jax_mnist.main(["--trainLocation", train, "--testLocation", test, *MNIST_FLAGS,
                            "--pipelineFile", str(tmp_path / "port")])
    np.testing.assert_array_equal(jback["test_predictions"], fitted["test_predictions"])


VOC_SMALL = ["--lambda", "0.05", "--descDim", "16", "--vocabSize", "8",
             "--numPcaSamples", "6000", "--numGmmSamples", "6000", "--scaleStep", "0"]


@pytest.fixture(scope="module")
def voc_tar(tmp_path_factory):
    """The tar of ``test_torch_voc_sift_fisher.py``: 24 JPEGs of 4
    separable classes serving both splits, and its labels CSV."""
    d = tmp_path_factory.mktemp("voc")
    labels = str(d / "labels.csv")
    open(labels, "w").close()
    write_voc_tar(str(d / "train.tar"), labels, 24, np.random.default_rng(42))
    return str(d / "train.tar"), labels


def test_voc_pipeline_file_across_packages(voc_tar, tmp_path):
    tar, labels = voc_tar
    base = ["--testLocation", tar, "--labelPath", labels, *VOC_SMALL]
    jres = jax_voc.main(["--trainLocation", tar, *base, "--pipelineFile", str(tmp_path / "jax")])
    absent = ["--trainLocation", str(tmp_path / "absent.tar")]
    restored = pt_voc.main([*absent, *base, "--device", "cpu",
                            "--pipelineFile", str(tmp_path / "jax")])
    assert restored["restored"] is True
    assert "sift_seconds" not in restored  # nothing was fitted
    assert restored["map"] == jres["map"]

    fitted = pt_voc.main(["--trainLocation", tar, *base, "--device", "cpu",
                          "--pipelineFile", str(tmp_path / "port")])
    assert np.all(fitted["aps"][:4] > 0.9), fitted["aps"]
    again = pt_voc.main([*absent, *base, "--device", "cpu",
                         "--pipelineFile", str(tmp_path / "port")])
    np.testing.assert_array_equal(again["test_scores"], fitted["test_scores"])
    # From the tar with the decode on the device: only the test split streams.
    streamed = pt_voc.main([*absent, *base, "--device", "cpu", "--streamIngest",
                            "--deviceDecode", "--pipelineFile", str(tmp_path / "port")])
    assert set(streamed["ingest"]) == {"test"}
    assert np.all(streamed["aps"][:4] > 0.9), streamed["aps"]
    jback = jax_voc.main(["--trainLocation", tar, *base, "--pipelineFile", str(tmp_path / "port")])
    assert jback["map"] == fitted["map"]
