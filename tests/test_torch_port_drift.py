"""PyTorch port: compound drift of its quantized DiT paths against its own
exact path over chained denoise steps, at the JAX gates' thresholds
(tests/test_attention_int8_drift.py, tests/test_dit_int8_drift.py), on
the CPU in f32 (diffusion/drift.py). The flash route runs the kernels'
plain versions at the kernel's kv tile (attention.KERNEL_BLOCK_KV); the
same gates run on the card through the kernels in bf16
(tests/test_torch_port_cuda.py, chip_smoke.py).

Each gate also shows that its quantized path engaged: the end outputs
differ, and the plain version of the variant (int8 scores, int8_pv) or the
W8A8 product ran, counted here by wrapping it. The attention gates also
hold the drift under 5 % of what attention itself moves the end output
(drift.SHARE_LIMIT; readings here 3e-4 and 4e-4): JAX's thresholds alone
pass an attention that gives zeros at this configuration."""

import pytest
import torch

from landiff_tpu_torch.diffusion import drift
from landiff_tpu_torch.models import dit as TD
from landiff_tpu_torch.ops import attention as TA

torch.set_num_threads(2)   # tier-1 runs six xdist workers


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(kw)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("gate", ["int8", "int8_pv", "w8a8"])
def test_quantized_dit_drift_is_bounded(monkeypatch, gate):
    int8_calls = _counting(monkeypatch, TA, "flash_int8_plain")
    exact_calls = _counting(monkeypatch, TA, "flash_exact_plain")
    w8a8_calls = _counting(monkeypatch, TD, "_w8a8_matmul")
    res = drift.run_gate(gate, device="cpu", dtype=torch.float32)
    print(gate, res)
    corr_above, rel_below = drift.GATES[gate]
    assert res["max_abs_diff"] > 0                  # the path engaged...
    assert res["corr"] > corr_above, res            # ...and drifts little
    assert res["rel"] < rel_below, res
    if gate != "w8a8":   # and it moves attention's own share little
        assert res["share_of_attention"] < drift.SHARE_LIMIT, res
    assert res["passed"]
    # 3 steps x (2 main + 1 control layers) x CFG-free batch of 2: one
    # attention call per layer and step
    calls = drift.STEPS * 3
    if gate == "w8a8":
        assert not int8_calls and not exact_calls    # the dense route
        assert len(w8a8_calls) == calls * 4          # four linears a layer
    else:
        assert len(exact_calls) == calls             # the exact run
        assert len(int8_calls) == calls
        assert all(kw.get("int8_pv") == (gate == "int8_pv")
                   for kw in int8_calls)
        assert not w8a8_calls
