"""The port stands alone: importing it loads neither JAX nor brancher_tpu
and builds nothing, and no module of it (nor chip_smoke.py, nor an example
or tutorial of the port) imports the JAX package."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "brancher_torch"


def test_import_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, json, brancher_torch, brancher_torch.inference, brancher_torch.ops.glm, "
        "brancher_torch.ops.leapfrog, brancher_torch.ops.logreg, brancher_torch.ops.batched_hmc, "
        "brancher_torch.models, brancher_torch.bridge, brancher_torch.ops.cuda_build, "
        "brancher_torch.functions, brancher_torch.optimizers, brancher_torch.inference.svi, "
        "brancher_torch.inference.guides, brancher_torch.inference.gradient_estimators, "
        "brancher_torch.models.vae, brancher_torch.stochastic_processes, "
        "brancher_torch.inference.smc, brancher_torch.inference.tempered_smc, "
        "brancher_torch.inference.streaming_smc, brancher_torch.inference.pmmh, "
        "brancher_torch.inference.particle_gibbs, brancher_torch.models.autoregressive, "
        "brancher_torch.models.state_space, brancher_torch.distributions, "
        "brancher_torch.transforms, brancher_torch.standard_variables, "
        "brancher_torch.transformations, brancher_torch.model_comparison, "
        "brancher_torch.inference.particle_inference_tools, brancher_torch.pandas_interface, "
        "brancher_torch.serialization, brancher_torch.checkpoint, brancher_torch.metrics, "
        "brancher_torch.visualizations, brancher_torch.dashboard, brancher_torch.utilities, "
        "brancher_torch.parallel, brancher_torch.parallel.collectives, "
        "brancher_torch.ops.resampling;"
        "print(json.dumps({'jax': 'jax' in sys.modules, "
        "'tpu': any(m.startswith('brancher_tpu') for m in sys.modules), "
        "'loaded': sorted(brancher_torch.ops.cuda_build._loaded)}))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"jax": False, "tpu": False, "loaded": []}


def _jax_imports(paths):
    """``file: module`` for every import of the JAX stack or brancher_tpu."""
    offenders = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "brancher_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {name}")
    return offenders


def test_no_example_or_tutorial_of_the_port_imports_jax_or_brancher_tpu():
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    tutorials = sorted((ROOT / "tutorials" / "torch").glob("*.py"))
    # the seven examples and eight tutorials of the JAX package, by name
    assert [p.name for p in examples] == sorted(p.name for p in (ROOT / "examples").glob("0*.py"))
    assert [p.name for p in tutorials] == sorted(p.name for p in (ROOT / "tutorials").glob("0*.py"))
    offenders = _jax_imports(examples + tutorials)
    assert not offenders, offenders


def test_no_module_of_the_port_imports_jax_or_brancher_tpu():
    offenders = _jax_imports(sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"])
    assert not offenders, offenders
    for source in ("glm_vg.cu", "leapfrog.cu"):
        assert (PORT / "csrc" / source).exists()
    # the walk covers this slice's modules
    for module in ("functions.py", "optimizers.py", "inference/svi.py", "inference/guides.py",
                   "inference/gradient_estimators.py", "models/vae.py", "stochastic_processes.py",
                   "inference/smc.py", "inference/tempered_smc.py", "inference/streaming_smc.py",
                   "inference/pmmh.py", "inference/particle_gibbs.py", "models/autoregressive.py",
                   "models/state_space.py", "distributions.py", "transforms.py",
                   "standard_variables.py", "transformations.py", "model_comparison.py",
                   "inference/particle_inference_tools.py", "pandas_interface.py",
                   "serialization.py", "checkpoint.py", "metrics.py", "visualizations.py",
                   "dashboard.py", "utilities.py", "parallel/mesh.py", "parallel/collectives.py",
                   "ops/resampling.py"):
        assert (PORT / module).exists()
