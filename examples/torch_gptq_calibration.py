"""GPTQ calibration on the PyTorch port — data-dependent quantization
(paper §3).

Trains the Llama smoke model briefly, then quantizes its projections three
ways (naive per-tensor like the paper's Listing 1, naive per-channel, and
GPTQ with calibration activations) and reports each one's loss
degradation: the paper's reason for adopting GPTQ.

    PYTHONPATH=src python examples/torch_gptq_calibration.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import gptq
from repro_torch.core.quant import QuantConfig, dequantize, quantize
from repro_torch.models import lm as LM
from repro_torch.train import tree as T
from repro_torch.train.steps import cross_entropy
from repro_torch.train.trained import trained_tiny_model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default; 'cpu' to run there")
    args = ap.parse_args(argv)
    cfg, params, data = trained_tiny_model("llama3.2-1b", steps=args.steps,
                                           device=args.device)
    device = T.leaves(params)[0].device
    batch = {k: v.to(device) for k, v in data.batch_at(9000).items()}

    @torch.no_grad()
    def eval_loss(p):
        logits, _, _ = LM.forward(p, cfg, batch["tokens"])
        return float(cross_entropy(logits, batch["labels"]))

    base = eval_loss(params)
    print(f"fp32 loss: {base:.4f}")
    # calibration: the residual stream's final hidden states stand in for
    # every projection's inputs (as the reference's example does)
    with torch.no_grad():
        hidden, _, _ = LM.forward(params, cfg,
                                  data.batch_at(500)["tokens"].to(device),
                                  return_hidden=True)
    calib = hidden.reshape(-1, cfg.d_model)
    out = {"fp32": base}
    for scheme in ("naive-per-tensor", "naive-per-channel", "gptq"):
        def q_one(name, p):
            if p.ndim != 2 or p.numel() < 1024 or "norm" in name:
                return p
            if scheme == "naive-per-tensor":
                return dequantize(quantize(p, QuantConfig(
                    bits=args.bits, granularity="per_tensor")))
            if scheme == "naive-per-channel" or p.shape[1] != cfg.d_model:
                return dequantize(quantize(p, QuantConfig(bits=args.bits)))
            h = gptq.accumulate_hessian(
                gptq.init_hessian(p.shape[1], device=device), calib)
            return dequantize(gptq.gptq_quantize(
                p, h, QuantConfig(bits=args.bits)))

        qp = T.unflatten(params, [q_one(n, p) for n, p in
                                  T.flatten(params)])
        out[scheme] = loss = eval_loss(qp)
        print(f"{scheme:20s} {args.bits}-bit loss: {loss:.4f}  "
              f"(delta {loss - base:+.4f})")
    return out


if __name__ == "__main__":
    main()
