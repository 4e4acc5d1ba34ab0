"""Package build (role of the reference's setup.py/install.sh torch
CUDAExtension — here a pure-Python package; the optional native host
library is built on demand at import, no compile step at install time)."""

from setuptools import find_packages, setup

setup(
    name="dpf_tpu",
    version="0.1.0",
    description=("TPU-native Distributed Point Functions / two-server PIR "
                 "(JAX/XLA/shard_map)"),
    packages=find_packages(include=["dpf_tpu", "dpf_tpu.*",
                                    "dpf_tpu_torch", "dpf_tpu_torch.*"]),
    # dpf_tpu_torch's CUDA sources are compiled by nvcc at first use
    package_data={"dpf_tpu.native": ["src/*.cpp", "src/*.h"],
                  "dpf_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "dpf_tpu_torch.native": ["src/*.cpp", "src/*.h"],
                  "dpf_tpu_torch.obs": ["spanring.c"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={
        "models": ["flax", "optax", "orbax-checkpoint"],
        "plots": ["matplotlib"],
        "torch": ["torch"],     # the PyTorch / CUDA port, dpf_tpu_torch
    },
)
