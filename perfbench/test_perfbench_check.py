"""The check that decides ``correct``, driven through a whole run on the CPU
at a tiny size (the harness's look for a card skipped): a sound run comes
out correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault a serving cell can have; and a run with the
control, the reference in fp8, in the program's place comes out not
correct. The rate sweep drives the same run.

The tiny models compute in float32, where the program and its references
agree to rounding; the cells' own limits are for bf16 at full size."""

import sys

import pytest
import torch

import pb_common as pc

sys.path.insert(0, str(pc.ROOT / "src"))

import pb_harness  # noqa: E402
from repro_torch.modeling.lm import LM  # noqa: E402
from repro_torch.modeling.mamba import MambaLM  # noqa: E402

TINY = {
    "olmoe-long": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, vocab=128, n_experts=8, top_k=2,
                       d_ff_expert=32, d_ff=32, moe_group=16,
                       dtype="float32"),
    "mamba2-long": dict(n_layers=4, d_model=64, vocab=128, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=16, dtype="float32"),
}
SMALL = {"calibration": {"n_tasks": 2, "mean_tokens": 64.0},
         "window": {"slice_tasks": 6, "warmup_slices": 1},
         "traffic": {"rate_per_s": 40.0}}


def run(cell, seed=2**31 + 7, hook=None, control=None):
    torch.manual_seed(0)
    return pb_harness.run_cell(cell, seed, 0.5, False, device="cpu",
                               config_overrides=TINY[cell],
                               workload_overrides=SMALL, program_hook=hook,
                               control=control, log=lambda m: None)


def frozen_state(orig):
    """A decode step that returns its state unchanged."""
    def step(self, params, cache, batch):
        keep = {k: v.clone() for k, v in cache.items()}
        logits, cache = orig(self, params, cache, batch)
        for k, v in keep.items():
            cache[k].copy_(v)
        return logits, cache
    return step


def altered_answer(orig):
    """A decode step whose logits are altered where they are produced."""
    def step(self, params, cache, batch):
        logits, cache = orig(self, params, cache, batch)
        return logits.index_add(-1, torch.tensor([3]),
                                torch.ones_like(logits[..., :1])), cache
    return step


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out["checks"])[-1] == "executions_compared"


# Each fault with the number that has to catch it: in the dense family
# every decode step writes the last slot of the prompt's cache (the
# program's clamped write), so a cache left unchanged moves the logits by
# less than bf16 does, and the slot's keys and values are compared.
FAULTS = [("mamba2-long", frozen_state, "logit_err"),
          ("mamba2-long", altered_answer, "logit_err"),
          ("olmoe-long", frozen_state, "kv_err"),
          ("olmoe-long", altered_answer, "logit_err")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=["state_unchanged-mamba2-long",
                              "answer_altered-mamba2-long",
                              "state_unchanged-olmoe-long",
                              "answer_altered-olmoe-long"])
def test_broken_step_is_not_correct(cell, fault, number, monkeypatch):
    model = MambaLM if cell.startswith("mamba") else LM
    monkeypatch.setattr(model, "decode_step", fault(model.decode_step))
    out = run(cell)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_altered_placement_and_price_are_not_correct():
    def misplace(rt):
        orig = rt.engine.place_many

        def place_many(tasks, *a, **kw):
            d = orig(tasks, *a, **kw)
            d.target_codes[0] = (d.target_codes[0] + 1) % len(d.names)
            return d
        rt.engine.place_many = place_many

    out = run("olmoe-long", hook=misplace)
    assert out["checks"]["placement_mismatch"]["value"] > 0
    assert not out["correct"]

    def overprice(rt):
        from repro_torch.core.pricing import SlicePricing

        rt.backend.pricing = SlicePricing(chip_hour_rate=1.25)

    out = run("olmoe-long", hook=overprice)
    assert out["checks"]["record_rel_err"]["value"] > 1e-9
    assert not out["correct"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_in_the_programs_place_is_not_correct(cell):
    out = run(cell, control="fp8")
    assert not out["correct"]
    c = out["checks"]
    assert c["executions_compared"]["value"] >= 1
    assert all(c[k]["value"] <= c[k]["limit"] for k in (
        "unserved", "placement_mismatch", "prediction_rel_err",
        "record_rel_err"))
    assert any(c[k]["value"] > c[k]["limit"] for k in ("logit_err", "kv_err")
               if k in c)
    # the program's own readings of the same executions hold the limits
    for k, v in out["readings"]["served"].items():
        if k in out["checks"]:
            assert v <= out["checks"][k]["limit"]


def test_sweep_drives_the_run():
    sweep = pc.load_module(pc.HERE / "sweep.py")
    keep: dict = {}
    rows = [sweep.sweep_rate("olmoe-long", 11, 0.5, rate, keep,
                             device="cpu", config_overrides=TINY["olmoe-long"],
                             workload_overrides=SMALL, log=lambda m: None)
            for rate in (10.0, 80.0)]
    assert [r["rate"] for r in rows] == [10.0, 80.0]
    assert all(r["correct"] and r["tasks"] > 0 for r in rows)
    assert len(rows[0]["queue_ms_by_fifth"]) == 5
    # the calibrated catalog is made once
    assert set(keep) == {"cat"}
    assert rows[1]["stream_s"] < rows[0]["stream_s"]
