from pathlib import Path

from setuptools import find_packages, setup

here = Path(__file__).parent
version = {}
exec((here / "clearml_serving_tpu" / "version.py").read_text(), version)

setup(
    name="clearml-serving-tpu",
    version=version["__version__"],
    description=(
        "TPU-native model serving: CLI + control plane + JAX/XLA/Pallas engine "
        "tier with clearml-serving capability parity"
    ),
    long_description=(here / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["clearml_serving_tpu*"]),
    include_package_data=True,
    package_data={"clearml_serving_tpu.native": ["*.cpp", "Makefile"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "numpy",
        "aiohttp",
        "requests",
        "msgpack",
        "grpcio",
        "prometheus-client",
    ],
    extras_require={
        "cpu-engines": ["scikit-learn", "joblib", "xgboost", "lightgbm"],
        "kafka": ["kafka-python"],
        "tokenizers": ["transformers", "tokenizers"],
    },
    entry_points={
        "console_scripts": [
            "tpu-serving = clearml_serving_tpu.__main__:main",
            "tpu-serving-inference = clearml_serving_tpu.serving.main:main",
            "tpu-serving-engine = clearml_serving_tpu.engine_server.server:main",
            "tpu-serving-statistics = clearml_serving_tpu.statistics.main:main",
            # the PyTorch/H100 port's CLI and inference server
            "tpu-serving-torch = clearml_serving_tpu_torch.__main__:main",
            "tpu-serving-torch-inference = clearml_serving_tpu_torch.serving.main:main",
            "tpu-serving-torch-statistics = clearml_serving_tpu_torch.statistics.main:main",
            "tpu-serving-torch-engine = clearml_serving_tpu_torch.engine_server.server:main",
        ]
    },
)
