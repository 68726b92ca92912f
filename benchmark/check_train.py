"""The comparison that decides ``correct`` in a training cell: sampled timed
steps of the program against the plain training reference
(``reference/hrviton_train.py``), stage by stage.

A sampled step is what the driver copied to host memory around it: the
batch, both noise fields, each network's parameters (with u/v), Adam
moments and update count before and after the step, the gradients the step
left in ``.grad``, its losses, and what the step's own graph wrote of its
conditioning (the generator's input and the labels), of G's output in the G
update and of D's logits in the D update (``GeneratorTrainer.held``). The
reference recomputes, in float32:

- the conditioning from the batch;
- the G update from the program's state before the step and the
  program's own conditioning (with random weights the argmax of the
  blurred segmentation flips at near-ties under any rounding, and a flipped
  label rewrites the modulation of a whole region: the inference check's
  rule, ``check.py``): its losses and G's gradient;
- the D update from the program's own updated G (so that a gap of G's
  update does not reach D's numbers): its losses and D's gradient;
- Adam on the program's own gradients and moments, against the program's
  updated parameters and moments (float32 against float32).

The numbers (each the worst sampled step's):

- ``warp_mae``: the warped cloth of the generator's input against the
  reference's, mean absolute gap (the images are in [-1, 1]);
- ``fake_mae``: G's output in the G update against the reference's G
  forward from the same state, conditioning and noise, mean absolute gap;
- ``d_logit_rel``: D's logits in the D update (every scale, fake and real,
  one vector) against the reference's from the program's updated G and D's
  state before the step, relative L2 gap;
- ``loss_gap``: every loss term (G's hinge, feature matching and VGG; D's
  fake and real hinge terms), |program - reference| over the reference's
  term; G's hinge term, a mean of logits near 0, over the fake logits'
  mean magnitude instead;
- ``g_grad_rel`` / ``d_grad_rel``: the relative L2 gap of the network's
  whole gradient (every parameter, one vector);
- ``g_grad_cos_gap`` / ``d_grad_cos_gap``: 1 - the cosine of the same
  vectors;
- ``sn_gap``: the largest L2 gap of a spectral conv's new u or v (unit
  vectors) over both networks;
- ``adam_gap``: the largest relative L2 gap of a network's update (the
  parameters' change), first moment or second moment against Adam(0, 0.9)
  with bias correction on the program's own gradients.

``correct``: every number finite and at or under its limit in the
configuration's ``limits``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from benchmark.reference import hrviton as ref_infer
from benchmark.reference import hrviton_train as ref

__all__ = ["NUMBERS", "numbers", "numbers_of", "judge", "to_device",
           "conditioning_of"]

NUMBERS = ("warp_mae", "fake_mae", "d_logit_rel", "loss_gap", "g_grad_rel",
           "g_grad_cos_gap", "d_grad_rel", "d_grad_cos_gap", "sn_gap",
           "adam_gap")
# the program's metric of each loss term, the reference's, and its scale
LOSSES = (("loss/gen/GAN", "GAN", "GAN_scale"),
          ("loss/gen/GAN_Feat", "GAN_Feat", "GAN_Feat"),
          ("loss/gen/VGG", "VGG", "VGG"),
          ("loss/dis/adv_fake", "adv_fake", "adv_fake"),
          ("loss/dis/adv_real", "adv_real", "adv_real"))


def to_device(tree, device):
    """Every tensor of a nested dict / list as float32 on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device, torch.float32)
    return tree


def _vec(d, keys):
    return torch.cat([d[k].reshape(-1).double() for k in keys])


def _rel(a, b) -> float:
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _cos_gap(a, b) -> float:
    den = float(torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b))
    return 1.0 - float(torch.dot(a, b)) / den if den > 0 else math.inf


def _opt(net) -> ref.Opt:
    return ref.Opt(net["exp_avg"], net["exp_avg_sq"], net["count"])


def _adam_gap(before, after, grads, lr, train) -> float:
    """The program's update of one network against the reference's Adam
    on the program's gradients and moments."""
    keys = sorted(grads)
    params, opt = ref.adam(before["params"], grads, _opt(before), lr,
                           train["beta1"], train["beta2"])
    p0 = _vec(before["params"], keys)
    return max(_rel(_vec(after["params"], keys) - p0, _vec(params, keys) - p0),
               _rel(_vec(after["exp_avg"], keys), _vec(opt.exp_avg, keys)),
               _rel(_vec(after["exp_avg_sq"], keys), _vec(opt.exp_avg_sq, keys)))


def _sn_gap(got, want) -> float:
    out = 0.0
    for name in ref.spectral_names(want):
        for k in (f"{name}.u", f"{name}.v"):
            out = max(out, float(torch.linalg.vector_norm(
                got[k].double() - want[k].double())))
    return out


def conditioning_of(cond, config):
    """The program's conditioning of a step ({'x': (N, H, W, 9), 'labels':
    (N, H, W)}) as the reference's per-sample triples (NCHW)."""
    out = []
    for s in range(cond["x"].shape[0]):
        labels = cond["labels"][s:s + 1].long()
        out.append((cond["x"][s:s + 1].float().permute(0, 3, 1, 2),
                    ref_infer._onehot(labels, config["generator"]["gen_semantic_nc"]),
                    labels))
    return out


def _by_part(prog, ref_grads, part) -> Dict[str, float]:
    """The relative L2 gap of a gradient over each group of parameters
    ``part(name)`` names."""
    groups: Dict[str, list] = {}
    for k in sorted(ref_grads):
        groups.setdefault(part(k), []).append(k)
    return {g: _rel(_vec(prog, keys), _vec(ref_grads, keys))
            for g, keys in groups.items()}


def numbers_of(taken, config, frozen, device,
               detail: bool = False) -> Dict[str, float]:
    """The numbers of one sampled step ``taken`` (module docstring; its
    tensors on the host or ``device``), the reference on ``device`` with
    the frozen networks ``frozen`` ({'tocg', 'vgg'}). ``detail`` adds, for
    calibration, each loss term's gap (``loss_gap.<term>``) and the
    gradients' gaps by G block and pyramid conv (``g_grad_rel.<part>``)
    and by D scale (``d_grad_rel.<scale>``)."""
    t = to_device({k: v for k, v in taken.items() if k != "raw"}, device)
    frozen = to_device(frozen, device)
    train = config["train"]
    gb, db = t["before"]["generator"], t["before"]["discriminator"]
    ga, da = t["after"]["generator"], t["after"]["discriminator"]
    raw = taken["raw"]
    cond = conditioning_of(t["cond"], config)
    warp = 0.0
    for s, part in enumerate(ref.samples(raw)):
        mine = ref.conditioning(ref.Precision(), frozen["tocg"], config,
                                ref.expand(part, device))[0]
        warp = max(warp, float((cond[s][0][:, 6:9] - mine[:, 6:9]).abs().mean()))
    rg = ref.g_step(frozen, gb["params"], _opt(gb), db["params"], raw,
                    t["fields_g"], config, device, cond=cond)
    rd = ref.d_step(frozen, ga["params"], db["params"], _opt(db), raw,
                    t["fields_d"], config, device, cond=rg.pop("cond"))
    want = {**rg["losses"], **rd["losses"]}
    gaps = {r: abs(t["losses"][p] - want[r]) / abs(want[s]) for p, r, s in LOSSES}
    fake = t["fake"].permute(0, 3, 1, 2)
    logits = lambda maps: torch.cat([m.reshape(-1).double() for m in maps])
    out = {"warp_mae": warp,
           "fake_mae": float((fake - rg["fake"]).abs().mean()),
           "d_logit_rel": _rel(logits(t["d_logits"]), logits(rd["logits"])),
           "loss_gap": max(gaps.values())}
    if detail:
        out.update({f"loss_gap.{k}": v for k, v in gaps.items()})
        out.update({f"g_grad_rel.{k}": v for k, v in _by_part(
            t["grads"]["generator"], rg["grads"], lambda n: n.split(".")[0]).items()})
        out.update({f"d_grad_rel.{k}": v for k, v in _by_part(
            t["grads"]["discriminator"], rd["grads"],
            lambda n: n.split(".")[0]).items()})
    for net, prog, got in (("g", t["grads"]["generator"], rg["grads"]),
                           ("d", t["grads"]["discriminator"], rd["grads"])):
        keys = sorted(got)
        a, b = _vec(prog, keys), _vec(got, keys)
        out[f"{net}_grad_rel"] = _rel(a, b)
        out[f"{net}_grad_cos_gap"] = _cos_gap(a, b)
    out["sn_gap"] = max(_sn_gap(ga["params"], rg["params"]),
                        _sn_gap(da["params"], rd["params"]))
    out["adam_gap"] = max(
        _adam_gap(gb, ga, t["grads"]["generator"],
                  train["G_lr"] * ref.lr_multiplier(train, gb["count"]), train),
        _adam_gap(db, da, t["grads"]["discriminator"],
                  train["D_lr"] * ref.lr_multiplier(train, db["count"]), train))
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def numbers(taken: Sequence, config, frozen, device) -> Dict[str, float]:
    """The worst of each number over the sampled steps ``taken``."""
    if not taken:
        return dict.fromkeys(NUMBERS, math.inf)
    out = dict.fromkeys(NUMBERS, 0.0)
    for step in taken:
        for k, v in numbers_of(step, config, frozen, device).items():
            out[k] = max(out[k], v)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k] for k in NUMBERS)
