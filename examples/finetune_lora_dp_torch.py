"""DP-LoRA (paper Appendix E.2) on the PyTorch/CUDA port, via
PrivacyPolicy frozen groups: the base model and the low-rank adapters live
in ONE params tree; the policy freezes the base (``trainable=False``: no
tap differentiation, no per-sample norm, no weighted grad, no noise) and
clips the A/B adapters group-wise with their own thresholds.

The kernel_report shows the frozen taps are gone (the engine does no work
for them), the adapters' group norms agree with the Opacus-style
per-sample reference under the same policy, and the frozen base gets zero
grads. Runs on the card by default.

    PYTHONPATH=src python examples/finetune_lora_dp_torch.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.core.engine import PrivacyEngine, make_grad_fn
from repro_torch.core.noise import fold_in, prng_key
from repro_torch.core.policy import ParamGroup, PrivacyPolicy
from repro_torch.core.tape import Tape
from repro_torch.launch.train import resolve_device
from repro_torch.models import layers as L
from repro_torch.utils.tree import flatten, unflatten

D, FF, V, RANK, B, T = 64, 128, 256, 8, 8, 16
F32 = torch.float32


def init_params(seed: int, device):
    gen = L.generator(seed, device)

    def lora(din, dout):
        return {"A": {"w": L.normal_init(gen, (din, RANK), F32, 0.02)},
                "B": {"w": L.zeros_init(gen, (RANK, dout), F32)}}

    return {
        "base": {
            "embed": L.embedding_init(gen, V, D, F32),
            "up": L.linear_init(gen, D, FF, F32),
            "down": L.linear_init(gen, FF, D, F32),
            "head": L.linear_init(gen, D, V, F32),
        },
        "lora": {"up": lora(D, FF), "down": lora(FF, D)},
    }


def lora_linear(tape, name, base_p, lora_p, x, scale=2.0):
    """x @ (W_base + A B * scale); base AND adapter matmuls are all tapped:
    the policy decides which of them do DP book-keeping."""
    with tape.scope("base"):
        h = L.linear(tape, name, base_p, x)
    with tape.scope("lora"):
        u = L.linear(tape, f"{name}/A", lora_p["A"], x)
        v = L.linear(tape, f"{name}/B", lora_p["B"], u)
    return h + scale * v


def apply_fn(params, batch, tape: Tape):
    base, lora = params["base"], params["lora"]
    with tape.scope("base"):
        x = L.embedding(tape, "embed", base["embed"], batch["tokens"])
    h = lora_linear(tape, "up", base["up"], lora["up"], x)
    h = torch.nn.functional.gelu(h, approximate="tanh")
    h = lora_linear(tape, "down", base["down"], lora["down"], h)
    with tape.scope("base"):
        logits = L.linear(tape, "head", base["head"], x + h)
    return L.lm_per_sample_loss(logits[:, :-1], batch["tokens"][:, 1:])


POLICY = PrivacyPolicy(groups=(
    # adapters: each matrix family group-wise clipped to its own R_g;
    # sensitivity composes as sqrt(R_A^2 + R_B^2)
    ParamGroup("lora_A", r"lora/.*/A/.*", R=0.7, scope="group"),
    ParamGroup("lora_B", r"lora/.*/B/.*", R=0.7, scope="group"),
    # frozen base: no taps, no norms, no noise — zero grads come back
    ParamGroup("base", "base", trainable=False),
), mode="bk", sigma=0.5)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_params(0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(0, V, (B, T), generator=gen,
                                     device=dev, dtype=torch.int32)}

    engine = PrivacyEngine(apply_fn, POLICY)
    report = engine.kernel_report(params, batch)
    assert not any(k.startswith("base/") for k in report), report
    print(f"kernel_report taps (base frozen, adapters only): "
          f"{sorted(report)}")

    # sanity: BK == Opacus under the SAME policy, and base grads are zero
    ref_fn = make_grad_fn(apply_fn, dataclasses.replace(POLICY,
                                                        mode="opacus"))
    g1, a1 = engine.grad(params, batch, prng_key(3), 0)
    g2, a2 = ref_fn(params, batch, prng_key(3), 0)
    for name in ("lora_A", "lora_B"):
        torch.testing.assert_close(a1["group_norms"][name],
                                   a2["group_norms"][name], rtol=1e-4,
                                   atol=1e-6)
    assert all(bool(torch.all(x == 0)) for x in flatten(g1["base"]).values())
    print("DP-LoRA: BK == Opacus on adapters; zero base grads; group norms",
          {k: v[:2].tolist() for k, v in a1["group_norms"].items()})

    lr, losses = 1e-2, []
    for step in range(args.steps):
        grads, aux = engine.grad(params, batch, fold_in(prng_key(4), step),
                                 step)
        fg = flatten(grads)
        params = unflatten({k: p - lr * fg[k]
                            for k, p in flatten(params).items()})
        losses.append(float(aux["loss"]))
        if step % 3 == 0:
            print(f"step {step}: loss {losses[-1]:.4f}")
    print("OK — DP-LoRA fine-tuning with a frozen-group PrivacyPolicy.")
    return losses


if __name__ == "__main__":
    main()
