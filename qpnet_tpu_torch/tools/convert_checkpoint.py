"""Convert a reference (PyTorch) QPNet checkpoint into the parameter tree
that both packages load, so the released pretrained models (reference
README.md:143-151) decode directly.  Same argv as
`qpnet_tpu.tools.convert_checkpoint`; the mapping is numpy only.

  python -m qpnet_tpu_torch.tools.convert_checkpoint \
      --checkpoint checkpoint-200000.pkl --out exp/checkpoint-final.pkl \
      --config exp/model.conf

State-dict layout being converted (reference src/nets/qpnet.py:174-237):
  causal.conv.{weight (R,Q,2), bias}
  upsampling.conv.{weight (1,1,1,up), bias}
  dilF_sigmoid.{i}.conv.{weight (R,R,2), bias}   dilF_tanh.{i}...
  auxF_1x1_sigmoid.{i}.{weight (R,A,1), bias}    auxF_1x1_tanh.{i}...
  skipF_1x1.{i}.{weight (S,R,1), bias}           resF_1x1.{i}...
  dilA_sigmoid.{i}.conv{C,P}.{weight (R,R,1), bias}   dilA_tanh.{i}...
  auxA_1x1_*, skipA_1x1, resA_1x1, conv_post_{1,2}

Mapping into the fused layout (qpnet_tpu_torch/models/qpnet.py): Conv1d weight
(out,in,k) k-slices become (in,out) matrices; k=0 is the *previous* sample
tap and k=1 the current one (valid convolution, end-aligned); sigmoid/tanh
branches concatenate on the output axis; additive biases of dil+aux(+convP)
fold into one b_gate.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, Mapping

import numpy as np

from qpnet_tpu_torch.config import ModelConfig


def _t(w) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


def convert_state_dict(sd: Mapping[str, Any], cfg: ModelConfig
                       ) -> Dict[str, Any]:
    """Reference state_dict (tensors or ndarrays) -> a parameter tree of
    numpy arrays in the two packages' layout."""
    get = lambda k: _t(sd[k])

    def branch_pair(prefix_sig, prefix_tanh, kslice=None, key="weight"):
        ws = get(f"{prefix_sig}.{key}")
        wt = get(f"{prefix_tanh}.{key}")
        if kslice is not None:
            ws, wt = ws[:, :, kslice], wt[:, :, kslice]
        else:
            ws, wt = ws[:, :, 0], wt[:, :, 0]
        return np.concatenate([ws.T, wt.T], axis=1)  # (in, 2*out)

    params: Dict[str, Any] = {}
    cw = get("causal.conv.weight")                  # (R, Q, 2)
    params["embed_prev"] = cw[:, :, 0].T            # (Q, R)
    params["embed_cur"] = cw[:, :, 1].T
    params["b_causal"] = get("causal.conv.bias")
    params["up_w"] = get("upsampling.conv.weight").reshape(-1)
    params["up_b"] = get("upsampling.conv.bias").reshape(())

    def res_layer(i: int, kind: str) -> Dict[str, Any]:
        K = kind  # "F" or "A"
        if K == "F":
            w_cur = branch_pair(f"dilF_sigmoid.{i}.conv",
                                f"dilF_tanh.{i}.conv", kslice=1)
            w_prev = branch_pair(f"dilF_sigmoid.{i}.conv",
                                 f"dilF_tanh.{i}.conv", kslice=0)
            b_gate = np.concatenate([
                get(f"dilF_sigmoid.{i}.conv.bias")
                + get(f"auxF_1x1_sigmoid.{i}.bias"),
                get(f"dilF_tanh.{i}.conv.bias")
                + get(f"auxF_1x1_tanh.{i}.bias")])
        else:
            w_cur = branch_pair(f"dilA_sigmoid.{i}.convC",
                                f"dilA_tanh.{i}.convC")
            w_prev = branch_pair(f"dilA_sigmoid.{i}.convP",
                                 f"dilA_tanh.{i}.convP")
            b_gate = np.concatenate([
                get(f"dilA_sigmoid.{i}.convC.bias")
                + get(f"dilA_sigmoid.{i}.convP.bias")
                + get(f"auxA_1x1_sigmoid.{i}.bias"),
                get(f"dilA_tanh.{i}.convC.bias")
                + get(f"dilA_tanh.{i}.convP.bias")
                + get(f"auxA_1x1_tanh.{i}.bias")])
        return {
            "W_cur": w_cur,
            "W_prev": w_prev,
            "W_aux": branch_pair(f"aux{K}_1x1_sigmoid.{i}",
                                 f"aux{K}_1x1_tanh.{i}"),
            "b_gate": b_gate,
            "W_skip": get(f"skip{K}_1x1.{i}.weight")[:, :, 0].T,
            "b_skip": get(f"skip{K}_1x1.{i}.bias"),
            "W_res": get(f"res{K}_1x1.{i}.weight")[:, :, 0].T,
            "b_res": get(f"res{K}_1x1.{i}.bias"),
        }

    params["fixed"] = [res_layer(i, "F")
                       for i in range(len(cfg.dilationsF))]
    params["adaptive"] = [res_layer(i, "A")
                          for i in range(len(cfg.dilationsA))]
    params["W_post1"] = get("conv_post_1.weight")[:, :, 0].T
    params["b_post1"] = get("conv_post_1.bias")
    params["W_post2"] = get("conv_post_2.weight")[:, :, 0].T
    params["b_post2"] = get("conv_post_2.bias")
    return params


def load_torch_checkpoint(path: str):
    """Load a torch .pkl checkpoint without requiring CUDA."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a reference PyTorch QPNet checkpoint")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True,
                   help="output checkpoint-*.pkl path")
    p.add_argument("--network", default="default")
    p.add_argument("--n_aux", type=int, default=39)
    p.add_argument("--upsampling_factor", type=int, default=110)
    p.add_argument("--config", default=None,
                   help="also write a model.conf JSON here (what "
                        "qpnet_decode/validate/update expect)")
    args = p.parse_args(argv)
    cfg = ModelConfig.from_network_name(
        args.network, n_aux=args.n_aux,
        upsampling_factor=args.upsampling_factor)
    sd = load_torch_checkpoint(args.checkpoint)
    params = convert_state_dict(sd, cfg)
    with open(args.out, "wb") as f:
        pickle.dump({"model": params}, f)
    print(f"wrote {args.out}")
    if args.config:
        from qpnet_tpu_torch.config import RunConfig, TrainConfig
        RunConfig(model=cfg, train=TrainConfig()).save(args.config)
        print(f"wrote {args.config}")


if __name__ == "__main__":
    main()
