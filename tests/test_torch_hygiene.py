"""The port stands alone: ``paddle_tpu_torch`` imports no JAX and nothing of
``paddle_tpu``, and its entry points run on the card unless asked for the
CPU (they raise when CUDA is absent)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "paddle_tpu"


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference, paddle_tpu_torch.models\n"
        "import paddle_tpu_torch.inference.speculative\n"
        "import paddle_tpu_torch.models.generation\n"
        "import paddle_tpu_torch.ops.flash_attention\n"
        "import paddle_tpu_torch.ops.paged_attention\n"
        "import paddle_tpu_torch.ops.fused_adamw\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.optimizer.lr\n"
        "import paddle_tpu_torch.jit, paddle_tpu_torch.nn.functional.loss\n"
        "import paddle_tpu_torch.utils\n"
        "import paddle_tpu_torch.inference.admission\n"
        "import paddle_tpu_torch.inference.cache_tier\n"
        "import paddle_tpu_torch.obs, paddle_tpu_torch.obs.trace\n"
        "import paddle_tpu_torch.obs.metrics, paddle_tpu_torch.testing\n"
        "import paddle_tpu_torch.testing.chaos\n"
        "import paddle_tpu_torch.utils.resources\n"
        "import paddle_tpu_torch.utils.retries\n"
        "import paddle_tpu_torch.base.flags, paddle_tpu_torch.analysis\n"
        "import paddle_tpu_torch.distributed.store\n"
        "import paddle_tpu_torch.distributed.communication.flight_recorder\n"
        "import paddle_tpu_torch.obs.agg\n"
        "import paddle_tpu_torch.inference.supervisor\n"
        "import paddle_tpu_torch.inference.cluster\n"
        "import paddle_tpu_torch.inference.disagg\n"
        "import paddle_tpu_torch.testing.disagg_worker\n"
        "import paddle_tpu_torch.testing.supervisor_worker\n"
        "import paddle_tpu_torch.testing.router_worker\n"
        "import paddle_tpu_torch.jit.dy2static, paddle_tpu_torch.framework\n"
        "import paddle_tpu_torch.analysis.astutils, paddle_tpu_torch.autograd\n"
        "import paddle_tpu_torch.amp.debugging\n"
        "import paddle_tpu_torch.testing.capture\n"
        "import paddle_tpu_torch.training, paddle_tpu_torch.training.supervisor\n"
        "import paddle_tpu_torch.training.anomaly\n"
        "import paddle_tpu_torch.training.peer_snapshot\n"
        "import paddle_tpu_torch.training.telemetry\n"
        "import paddle_tpu_torch.incubate.checkpoint.auto_checkpoint\n"
        "import paddle_tpu_torch.distributed.checkpoint.reshard\n"
        "import paddle_tpu_torch.distributed.io\n"
        "import paddle_tpu_torch.distributed.fleet.elastic\n"
        "import paddle_tpu_torch.distributed.fleet.utils.fs\n"
        "import paddle_tpu_torch.testing.trainfault_worker\n"
        "import paddle_tpu_torch.testing.elastic_worker\n"
        "import paddle_tpu_torch.testing.elastic_shard_worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def test_no_source_file_imports_jax_or_reference_package():
    offenders = []
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}"
                          for n in names if _forbidden(n)]
    assert offenders == []


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    from paddle_tpu_torch import get_device
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.paged_attention import alloc_paged_kv_caches

    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alloc_paged_kv_caches(1, 1, 8, 1, 8, "float32", block_size=4)
    assert get_device("cpu").type == "cpu"
    LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
