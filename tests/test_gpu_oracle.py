"""Same-device GPU oracle: the CUDA traversal kernel against the
brute-force cast on the card, closest-hit, any-hit and carried u/v/n,
at the tolerances of tpu_raytracer/oracle.py.

Marked ``gpu``: the CPU suite skips these (the kernel's host build runs
the same checks there, tests/test_oracle.py). On the card they run as
phase 3 of ``python chip_smoke.py``, or alone with
``python tests/test_gpu_oracle.py``.
"""

import sys

import pytest

from tpu_raytracer.oracle import (
    ORACLE_SCENES, camera_rays, check_backend, oracle_scene,
)

GPU_SIZE = 192  # image side of the sized oracle scenes on the card


def run_case(name: str, size: int = GPU_SIZE) -> dict:
    scene, cam = oracle_scene(name, size)
    origin, directions = camera_rays(cam)
    return check_backend("cuda", scene, origin, directions)


def run_all(size: int = GPU_SIZE, log=print) -> bool:
    """Every oracle scene; logs one line each, returns overall success."""
    ok = True
    for name in ORACLE_SCENES:
        result = run_case(name, size)
        log(f"oracle {name}: {result}")
        ok = ok and result["ok"]
    return ok


@pytest.mark.gpu
@pytest.mark.parametrize("name", ORACLE_SCENES)
def test_cuda_kernel_matches_brute_on_card(gpu_device, name):
    result = run_case(name)
    assert result["ok"], result


if __name__ == "__main__":
    sys.exit(0 if run_all() else 1)
