"""Convert reference PyTorch ``.pth`` checkpoints to the JAX package's
msgpack ``.ckpt`` files: the port's counterpart of
``hrviton_tpu/cli/convert_checkpoint.py``, writing the same bytes.

Kinds: tocg (mtviton.pth), gen (gen.pth), cond_d (D_*.pth), vgg19 and
alexnet (torchvision), inception (torchvision inception_v3), lpips (alex.pth
with ``--backbone`` the torchvision alexnet). Runs on the host::

    python -m hrviton_tpu_torch.cli.convert_checkpoint tocg mtviton.pth tocg.ckpt
"""

from __future__ import annotations

import argparse

from hrviton_tpu_torch.train.checkpoint import (convert_alexnet,
                                                convert_cond_discriminator,
                                                convert_lpips_alex,
                                                convert_spade_gen,
                                                convert_tocg, convert_vgg19,
                                                load_torch_state_dict,
                                                save_pytree)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("kind", choices=["tocg", "gen", "cond_d", "vgg19",
                                    "alexnet", "lpips", "inception"])
    p.add_argument("src", help=".pth path (for lpips: the lin-head alex.pth)")
    p.add_argument("dst", help="output .ckpt (msgpack) path")
    p.add_argument("--backbone", default="",
                   help="for lpips: torchvision alexnet .pth")
    p.add_argument("--out_layer", default="relu")
    p.add_argument("--num_upsampling_layers", default="most")
    p.add_argument("--num_D", type=int, default=2)
    args = p.parse_args(argv)

    sd = load_torch_state_dict(args.src)
    if args.kind == "tocg":
        tree = convert_tocg(sd, out_layer=args.out_layer)
    elif args.kind == "gen":
        tree = convert_spade_gen(sd, args.num_upsampling_layers)
    elif args.kind == "cond_d":
        tree = convert_cond_discriminator(sd, num_d=args.num_D)
    elif args.kind == "vgg19":
        tree = convert_vgg19(sd)
    elif args.kind == "alexnet":
        tree = convert_alexnet(sd)
    elif args.kind == "inception":
        from hrviton_tpu_torch.models.inception import convert_inception_v3
        tree = convert_inception_v3(sd)
    else:
        if not args.backbone:
            raise SystemExit("lpips conversion needs --backbone alexnet.pth")
        tree = convert_lpips_alex(sd, load_torch_state_dict(args.backbone))
    save_pytree(tree, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
