from setuptools import setup, find_packages

setup(
    name="femo_tpu",
    version="0.1.0",
    description=(
        "TPU-native differentiable finite-element framework for "
        "PDE-constrained optimization (JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=["tests", "examples"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    # femo_tpu_torch, the PyTorch/CUDA port (found by find_packages), needs
    # torch; its CUDA kernels are built with nvcc at first use
    extras_require={"torch": ["torch"]},
)
