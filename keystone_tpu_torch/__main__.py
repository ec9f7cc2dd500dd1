"""Workload launcher: ``python -m keystone_tpu_torch <workload> [flags]``,
the port's counterpart of ``bin/run-pipeline``.

The same nine workloads and aliases (the reference's class names or the
module names) map to ``keystone_tpu_torch.workloads.<module>``, which runs
as ``python -m`` would run it, with the remaining flags untouched.  No
workload prints the usage and exits 1; an unknown one exits 2.

The script's two environment variables map onto the port's own settings:

* ``KEYSTONE_PLATFORM=cpu`` puts ``--device cpu`` ahead of the flags of
  every workload that takes ``--device`` (all but StupidBackoff, which runs
  on the host), so an explicit ``--device`` among the flags still wins.
* ``KEYSTONE_NUM_DEVICES=N`` asks for N CPU devices (and so implies the
  CPU).  A workload's ``--mesh`` takes the distinct devices of its
  ``--device`` kind (``parallel.mesh.parse_mesh``), and the CPU is one, so
  only N = 1 can be given; any other N exits 2 naming the gap rather than
  run on fewer devices than asked.

Without either, the workload runs on the CUDA card and raises where there
is none.  This module imports no torch: the workload does.
"""

from __future__ import annotations

import os
import runpy
import sys

USAGE = """\
Workload launcher for keystone_tpu_torch: the analog of bin/run-pipeline
(every pipeline is a python -m module; the "cluster" is the device mesh
selected with --mesh).  Workloads run on the CUDA card unless asked for
the CPU.

Usage:
  python -m keystone_tpu_torch <workload> [--mesh DxM] [workload flags...]

Workloads (aliases accept the reference class names):
  mnist_random_fft      | MnistRandomFFT
  cifar_random_patch    | RandomPatchCifar
  random_cifar          | RandomCifar
  linear_pixels         | LinearPixels
  timit                 | TimitPipeline
  newsgroups            | NewsgroupsPipeline
  stupid_backoff        | StupidBackoffPipeline
  voc_sift_fisher       | VOCSIFTFisher
  imagenet_sift_lcs_fv  | ImageNetSiftLcsFV

Env:
  KEYSTONE_PLATFORM=cpu      run on the CPU (--device cpu; StupidBackoff
                             runs on the host either way)
  KEYSTONE_NUM_DEVICES=N     N CPU devices (implies cpu); only N=1, since a
                             workload's --mesh takes the distinct devices of
                             its --device kind and the CPU is one"""

#: Reference class name -> workload module (``bin/run-pipeline``'s case).
CLASS_NAMES = {
    "MnistRandomFFT": "mnist_random_fft",
    "RandomPatchCifar": "cifar_random_patch",
    "RandomCifar": "random_cifar",
    "LinearPixels": "linear_pixels",
    "TimitPipeline": "timit",
    "NewsgroupsPipeline": "newsgroups",
    "StupidBackoffPipeline": "stupid_backoff",
    "VOCSIFTFisher": "voc_sift_fisher",
    "ImageNetSiftLcsFV": "imagenet_sift_lcs_fv",
}
#: Workloads with no ``--device`` flag: they run on the host.
HOST_ONLY = frozenset({"stupid_backoff"})

PLATFORM_ENV = "KEYSTONE_PLATFORM"
NUM_DEVICES_ENV = "KEYSTONE_NUM_DEVICES"


class LaunchError(ValueError):
    """An environment setting the port cannot honour (exit 2)."""


def resolve(name: str) -> str | None:
    """A workload alias -> its module name under ``workloads``, or None."""
    if name in CLASS_NAMES.values():
        return name
    return CLASS_NAMES.get(name)


def device_flags(module: str, env=None) -> list[str]:
    """The flags the environment adds ahead of the user's."""
    env = os.environ if env is None else env
    raw = env.get(NUM_DEVICES_ENV, "")
    cpu = env.get(PLATFORM_ENV, "") == "cpu"
    if raw:
        try:
            n = int(raw)
        except ValueError:
            raise LaunchError(f"{NUM_DEVICES_ENV}={raw!r} is not an integer") from None
        if n != 1:
            raise LaunchError(
                f"{NUM_DEVICES_ENV}={raw}: the port cannot give a workload {raw} CPU "
                "devices — its --mesh takes the distinct devices of the --device kind "
                "(parallel.mesh.parse_mesh), and the CPU is one; only "
                f"{NUM_DEVICES_ENV}=1 can be honoured"
            )
        cpu = True
    return ["--device", "cpu"] if cpu and module not in HOST_ONLY else []


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(USAGE)
        return 1
    name, flags = argv[0], argv[1:]
    module = resolve(name)
    if module is None:
        print(f"unknown workload: {name}", file=sys.stderr)
        return 2
    try:
        flags = device_flags(module) + flags
    except LaunchError as e:
        print(f"keystone_tpu_torch: {e}", file=sys.stderr)
        return 2
    target = f"keystone_tpu_torch.workloads.{module}"
    sys.argv = [target, *flags]
    runpy.run_module(target, run_name="__main__", alter_sys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
