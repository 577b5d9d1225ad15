"""The pieces the captured decode graphs rest on, on the CPU.

* ``sample_tokens`` with the EOS row built once by the caller (what a
  CUDA graph can capture) gives what the former call, which built the row
  itself, gives on the same inputs;
* launch counts of a captured graph are taken back at capture and added once
  per replay (``_kernels.CapturedCalls``), shown with a stub kernel;
* the pinned readback buffers' CPU form;
* ``--decode-steps`` and ``--no-async-decode`` reach ``SchedulerConfig``.
"""

import pytest
import torch

from rtp_llm_tpu_torch import _kernels
from rtp_llm_tpu_torch.cli import config_from_args, parse_args
from rtp_llm_tpu_torch.engine.decode_graphs import Readback
from rtp_llm_tpu_torch.ops.sampling import SamplingParams, eos_ban_row, sample_tokens

B, V, EOS = 6, 50, (2, 7)


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((B, V), generator=g) * 3
    logits[:, EOS[0]] += 8.0  # EOS would win every greedy row it is not banned from
    params = SamplingParams(
        temperature=torch.tensor([1.0, 0.7, 1.3, 0.9, 1.0, 0.5]),
        top_k=torch.tensor([0, 5, 0, 12, 3, 0], dtype=torch.int32),
        top_p=torch.tensor([1.0, 1.0, 0.8, 0.9, 1.0, 0.95]),
        do_sample=torch.tensor([False, True, True, True, False, True]),
        repetition_penalty=torch.tensor([1.0, 1.2, 1.0, 1.1, 1.0, 1.3]),
        presence_penalty=torch.tensor([0.0, 0.5, 0.0, 0.2, 0.0, 0.0]),
        frequency_penalty=torch.tensor([0.0, 0.0, 0.3, 0.1, 0.0, 0.2]),
        ban_eos=torch.tensor([True, False, True, False, False, True]))
    prompt_mask = torch.rand((B, V), generator=g) < 0.2
    counts = torch.randint(0, 3, (B, V), generator=g, dtype=torch.int32)
    active = torch.tensor([True, True, False, True, True, True])
    return logits, params, prompt_mask, counts, active


@pytest.mark.parametrize("need_sampling", [False, True])
@pytest.mark.parametrize("need_stats", [False, True])
def test_prebuilt_eos_row_matches_the_former_call(need_sampling, need_stats):
    outs = []
    for ban_row in (None, eos_ban_row(EOS, V, "cpu")):
        logits, params, pmask, counts, active = _inputs(0)
        gen = torch.Generator().manual_seed(5)
        tokens, logprobs = sample_tokens(
            logits, params, pmask, counts, EOS, gen, need_sampling=need_sampling,
            active=active, need_stats=need_stats, ban_row=ban_row)
        outs.append((tokens, logprobs, counts))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    tokens = outs[0][0]
    assert not torch.isin(tokens[[0, 2, 5]], torch.tensor(EOS)).any()
    assert tokens[4] == EOS[0]  # greedy, not banned


def test_eos_ban_row():
    row = eos_ban_row(EOS, V, "cpu")
    assert row.dtype == torch.bool and row.shape == (V,)
    assert row.nonzero().flatten().tolist() == list(EOS)


def _stub_kernel(name):
    k = _kernels.Kernel(name, "stub.cu", "stub", [])
    k._fn = lambda *args: 0  # a launch that returns cudaSuccess
    return k


def test_captured_calls_are_taken_back_and_added_per_replay():
    k, other = _stub_kernel("stub_a"), _stub_kernel("stub_b")
    plain = _kernels.Counter("stub_plain")
    k.launches.n, other.launches.n = 5, 2
    with _kernels.CapturedCalls() as calls:
        for _ in range(3):
            k.launch()
        plain.n += 1
    # capture ran nothing: the counts are as before it
    assert (k.launches.n, other.launches.n, plain.n) == (5, 2, 0)
    assert sorted((c.name, d) for c, d in calls.deltas) == [("stub_a", 3), ("stub_plain", 1)]
    calls.replay()
    calls.replay()
    k.launch()  # an eager launch between replays counts as one
    assert (k.launches.n, other.launches.n, plain.n) == (5 + 3 + 3 + 1, 2, 2)


def test_captured_calls_taken_back_when_the_capture_fails():
    k = _stub_kernel("stub_c")
    with pytest.raises(RuntimeError, match="capture failed"):
        with _kernels.CapturedCalls():
            k.launch()
            raise RuntimeError("capture failed")
    assert k.launches.n == 0


def test_readback_on_the_cpu():
    rb = Readback(batch=3, device=torch.device("cpu"))
    assert rb.event is None
    rb.start(torch.tensor([[4, 5, 6]]), torch.tensor([[-0.5, -1.0, -2.0]]), need_stats=True)
    assert rb.wait() == ([[4, 5, 6]], [[-0.5, -1.0, -2.0]])
    toks = torch.arange(12).reshape(4, 3)
    rb.start(toks, torch.zeros(4, 3), need_stats=False)  # grows to 4 steps
    assert rb.wait() == (toks.tolist(), None)
    rb.start(toks[:2], torch.zeros(2, 3), need_stats=False)
    assert rb.wait() == (toks[:2].tolist(), None)


@pytest.mark.parametrize("argv,steps,asy", [
    ([], 1, True),
    (["--decode-steps", "4"], 4, True),
    (["--no-async-decode"], 1, False),
    (["--decode-steps", "8", "--no-async-decode"], 8, False),
])
def test_decode_flags_reach_the_scheduler_config(argv, steps, asy):
    sc = config_from_args(parse_args(["serve", "/ckpt", *argv])).scheduler
    assert (sc.decode_steps, sc.async_decode) == (steps, asy)
