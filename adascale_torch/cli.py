"""Command line: ``python -m adascale_torch <command> ...``.

One-to-one with ``adascale/cli.py``:

  train    training.loop.train; ``--mesh`` trains data-parallel, one process
           a card under torchrun: ``python -m torch.distributed.run
           --standalone --nproc_per_node=N -m adascale_torch train --mesh
           ...`` (``--standalone`` meets on localhost; without torchrun
           ``--mesh`` runs at world size 1; ``--device cpu`` over gloo)
  export   training.loop.export_inference_artifact (a checkpoint of the port
           -> ``params.npz`` + ``model_config.json``, which ``detect`` serves)
  detect   AdaptiveScalingInference.detect -> char polygons JSON
  pt2      inference.export.export_program (the counterpart of ``stablehlo``)
  demo     inference.demo.infer: detect() and the ten visualisation images,
           as PNG

``detect`` and ``demo`` read PNG or an ``.npz`` page (``utils/png.py``).
``train``, ``detect``, ``demo`` and ``pt2`` run on the card unless
``--device cpu`` asks for the plain versions (``demo``: the inference
config's ``device`` unless ``--device`` is given).
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_train(args):
    from .training.loop import train

    metrics = train(
        dataset_config_json=args.dataset_config,
        output_folder=args.output,
        reset_output_folder=args.reset_output,
        epoch_config_json=args.epoch_config,
        model_config_json=args.model_config,
        optimizer_config_json=args.optimizer_config,
        rough_loss_config_json=args.rough_loss_config,
        precise_loss_config_json=args.precise_loss_config,
        restore_state_path=args.restore,
        use_mesh=args.mesh,
        device=args.device,
    )
    if os.environ.get("RANK", "0") == "0":
        print(json.dumps(metrics))


def _cmd_export(args):
    from .training.loop import export_inference_artifact

    print(export_inference_artifact(args.checkpoint, args.output, args.model_config))


def _cmd_demo(args):
    from .inference.demo import infer

    result = infer(args.config, args.image, args.output, device=args.device)
    print(json.dumps({"num_chars": len(result["char_polygons"]), "output": args.output}))


def _cmd_detect(args):
    from .inference.engine import AdaptiveScalingInference, AdaptiveScalingInferenceConfig
    from .models.adaptive_scaling import AdaptiveScalingConfig
    from .utils.config import load_config
    from .utils.png import read_image

    engine = AdaptiveScalingInference(
        AdaptiveScalingInferenceConfig(
            checkpoint=args.checkpoint,
            model=load_config(args.model_config, AdaptiveScalingConfig),
            compute_dtype=args.dtype,
            use_pallas_backbone=args.pallas,
            device=args.device,
        )
    )
    # Tri-state: --tiled forces tiling on, --no-tiled off, neither lets
    # config.tiled_rough_long_side_min decide.
    result = engine.detect(read_image(args.image), tiled=args.tiled)
    polygons = [p.points.tolist() for p in result["char_polygons"]]
    out = json.dumps({"num_chars": len(polygons), "char_polygons": polygons})
    if args.output:
        with open(args.output, "w") as fout:
            fout.write(out)
    else:
        print(out)


def _cmd_pt2(args):
    from .inference.export import export_program
    from .models.adaptive_scaling import AdaptiveScalingConfig
    from .utils.config import load_config
    from .utils.params import load_params

    model_config = load_config(args.model_config, AdaptiveScalingConfig)
    params = load_params(args.checkpoint, model_config)
    manifest = export_program(params, model_config, args.output, device=args.device)
    print(json.dumps(manifest))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="adascale_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="run the training loop")
    p.add_argument("--dataset-config", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--epoch-config")
    p.add_argument("--model-config")
    p.add_argument("--optimizer-config")
    p.add_argument("--rough-loss-config")
    p.add_argument("--precise-loss-config")
    p.add_argument("--restore")
    p.add_argument("--reset-output", action="store_true")
    p.add_argument(
        "--mesh", action="store_true",
        help="data-parallel over every rank of the process group (torchrun: one process a card)",
    )
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("export", help="checkpoint -> inference artifact (params.npz, model_config.json)")
    p.add_argument("--checkpoint", required=True, help="a training checkpoint of the port (state_<epoch>)")
    p.add_argument("--output", required=True)
    p.add_argument("--model-config")
    p.set_defaults(fn=_cmd_export)

    p = sub.add_parser("demo", help="two-stage inference + visualization images (PNG)")
    p.add_argument("--config", required=True, help="inference config JSON (AdaptiveScalingInferenceConfig)")
    p.add_argument("--image", required=True, help="page image, PNG or .npz")
    p.add_argument("--output", required=True)
    p.add_argument("--device", help="cuda (the kernels) or cpu (their plain versions); default: the config's")
    p.set_defaults(fn=_cmd_demo)

    p = sub.add_parser("detect", help="page image (PNG or .npz) -> char polygons JSON")
    p.add_argument("--checkpoint", required=True, help=".npz or reference state-dict file")
    p.add_argument("--image", required=True)
    p.add_argument("--model-config")
    p.add_argument("--output")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument(
        "--pallas", action="store_true",
        help="use_pallas_backbone: in bf16 the Pallas backbone's rounding; the backbone runs the block kernel either way",
    )
    p.add_argument(
        "--tiled",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="force tiling on (--tiled) or off (--no-tiled); default auto-decides from config",
    )
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(fn=_cmd_detect)

    p = sub.add_parser("pt2", help="checkpoint -> torch.export programs (.pt2) and manifest")
    p.add_argument("--checkpoint", required=True, help=".npz or reference state-dict file")
    p.add_argument("--output", required=True)
    p.add_argument("--model-config")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain versions)")
    p.set_defaults(fn=_cmd_pt2)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
