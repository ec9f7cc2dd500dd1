"""``python -m keystone_tpu_torch.tools.voc_leave2out_cv`` against the
unedited JAX tool (``tools/voc_leave2out_cv.py``) on a seeded 10-image VOC
directory (the reference fixture it names is on neither host): the JAX
script runs through ``runpy`` with the JAX loader pointed at that
directory, the port's tool reads it through ``--vocDir``/``--labels``.
Both hold out the same five pairs; each fold scores the same classes with
equal APs (the bar ``test_torch_voc_sift_fisher.py`` holds two decoders'
APs of the present classes to).

The JAX script's first fold compiles its VOC pipeline op by op (364 XLA
programs, ~20 s on an idle 8-core host, ~250 s under the tier-1 run's
parallel load), so the live comparison is ``slow``, like the JAX VOC mesh
comparisons of ``test_torch_fv_workloads_mesh.py``.  Tier-1 holds the
port's tool to :data:`JAX_LINES`, the JAX script's output on this set,
which the slow test re-reads from the script: the JAX package never
changes, so the record cannot drift from it unseen.

The port runs on two intra-op threads (:func:`two_threads`).  At this size
a fold's fitted model follows the reduction order: on one thread fold 1
ranks its two images the other way for class 2 (AP 1.0, not the JAX
script's 0.5), and on all eight of a host's threads the case took 152 s
under the tier-1 run's six workers against 2.4 s alone."""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from keystone_tpu_torch.tools import voc_leave2out_cv
from test_fisher_pipelines import write_voc_tar
from torch_plan_log import hermetic_plan_log, hermetic_plan_log_module  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

#: ``tools/voc_leave2out_cv.py``'s output on :func:`_voc_set`.
JAX_LINES = [
    "10 images; labels per image: [[0], [0], [2], [2], [3], [0], [0], [0], [1], [1]]",
    "fold 0: test=[4, 6] test_classes=[0, 3] scored=[0] aps=[1.0] foldMAP=1.000",
    "fold 1: test=[2, 7] test_classes=[0, 2] scored=[0, 2] aps=[1.0, 0.5] foldMAP=0.750",
    "fold 2: test=[3, 5] test_classes=[0, 2] scored=[0, 2] aps=[1.0, 1.0] foldMAP=1.000",
    "fold 3: test=[0, 9] test_classes=[0, 1] scored=[0, 1] aps=[1.0, 1.0] foldMAP=1.000",
    "fold 4: test=[1, 8] test_classes=[0, 1] scored=[0, 1] aps=[1.0, 1.0] foldMAP=1.000",
    "mean held-out MAP over 5 folds: 0.9500",
]


@pytest.fixture
def two_threads():
    """Two intra-op threads for the port's folds, whatever the host has."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _voc_set(root: Path) -> tuple[str, str]:
    """Ten seeded 64 px JPEGs of 4 classes in one VOC tar, and its labels."""
    voc_dir = root / "voc"
    voc_dir.mkdir()
    labels = root / "voclabels.csv"
    labels.write_text("")
    write_voc_tar(str(voc_dir / "voc.tar"), str(labels), 10, np.random.default_rng(11))
    return str(voc_dir), str(labels)


def _port_lines(voc_dir: str, labels: str, capsys) -> list:
    folds = voc_leave2out_cv.main(["--vocDir", voc_dir, "--labels", labels, "--device", "cpu"])
    assert sorted(i for fold in folds for i in fold[0]) == list(range(10))
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("argv", ([], ["--vocDir", "voc"], ["--labels", "voclabels.csv"]))
def test_voc_dir_and_labels_are_required(argv, capsys):
    """No default path: the JAX tool's fixture lies outside any checkout."""
    with pytest.raises(SystemExit) as e:
        voc_leave2out_cv.main(argv)
    assert e.value.code == 2 and "required" in capsys.readouterr().err


def test_folds_equal_the_jax_record(tmp_path, capsys, two_threads):
    assert _port_lines(*_voc_set(tmp_path), capsys) == JAX_LINES


@pytest.mark.slow
def test_folds_equal_jax(tmp_path, monkeypatch, capsys, two_threads):
    from keystone_tpu.loaders import image_loaders as jloaders

    voc_dir, labels = _voc_set(tmp_path)
    load = jloaders.voc_loader
    monkeypatch.setattr(jloaders, "voc_loader", lambda *_: load(voc_dir, labels))
    runpy.run_path(str(ROOT / "tools" / "voc_leave2out_cv.py"), run_name="__main__")
    ref = capsys.readouterr().out.splitlines()
    assert ref == JAX_LINES
    assert _port_lines(voc_dir, labels, capsys) == ref
