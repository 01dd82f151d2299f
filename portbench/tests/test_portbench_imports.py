"""Nothing the benchmark runs pulls in JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference pulls in nothing of the port."""
import subprocess
import sys

from portbench import spec

MODULES = ["portbench.run", "portbench.spec", "portbench.device", "portbench.trace",
           "portbench.counts", "portbench.judge", "portbench.traffic", "portbench.readings",
           "portbench.kinds.train", "portbench.kinds.serve"]
REFERENCE = ["portbench.reference", "portbench.reference.model", "portbench.reference.train",
             "portbench.reference.corpus", "portbench.reference.search"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    metrics = [m["name"] for m in spec.benchmark()["per_layer"]]
    code = "\n".join(f"import {m}" for m in MODULES) + "\nfrom portbench import spec\n" + "\n".join(
        f"spec.reader({m!r})" for m in metrics)
    assert not _loaded(code) & {"jax", "jaxlib", "flax", "rqvae_tpu"}


def test_a_run_loads_no_jax():
    """A whole run (tiny, on the CPU) with the port imported."""
    code = ("import torch\nfrom portbench import run\nfrom portbench.conftest import _tiny\n"
            "run.main(['--workload', 'amazon_train', '--seed', '5', '--seconds', '0.2', '--trace', '0'],"
            " device=torch.device('cpu'), adjust=_tiny)")
    loaded = _loaded(code)
    assert "rqvae_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rqvae_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert not loaded & {"rqvae_tpu_torch", "rqvae_tpu", "jax", "jaxlib", "flax"}
