"""Command-line interface of the port (counterpart of
cuda_ldpc_tpu/cli.py:68-218, the ``binary`` and ``list-codes`` subcommands).

Usage:
  python -m cuda_ldpc_torch binary --code J15_L30_Z1280 --snr 2:0.2:3
  python -m cuda_ldpc_torch binary --device cpu --code J4_L24_Z96 ...
  python -m cuda_ldpc_torch list-codes

Options the port does not run yet are still parsed, so that their values
are rejected with the ROADMAP.md item that ports them rather than with a bare
usage error.
"""

from __future__ import annotations

import argparse
import sys

from cuda_ldpc_tpu import cli as tpu_cli
from cuda_ldpc_tpu import config as cfg
from cuda_ldpc_tpu.utils import registry


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("binary", help="binary QC-LDPC min-sum FER sweep")
    bd = cfg.BinarySimConfig()
    b.add_argument("--code", default="J15_L30_Z1280",
                   choices=registry.BINARY_CODES, metavar="CODE")
    b.add_argument("--device", default="cuda",
                   help="cpu, cuda or cuda:N (no fallback: cuda without a "
                        "card is an error)")
    b.add_argument("--kernel", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="auto: the CUDA kernel on a CUDA device, plain "
                        "PyTorch on the CPU")
    b.add_argument("--schedule", choices=["flooding", "layered"],
                   default=bd.decoder.schedule)
    b.add_argument("--rule", choices=["minsum", "bp"], default=bd.decoder.rule)
    b.add_argument("--max-iters", type=int, default=bd.decoder.max_iters)
    b.add_argument("--alpha", type=float, default=bd.decoder.alpha,
                   help="normalization factor (reference uses 1.0)")
    b.add_argument("--beta", type=float, default=bd.decoder.beta,
                   help="offset min-sum beta")
    b.add_argument("--check", choices=["zero", "syndrome", "none"],
                   default=bd.decoder.check)
    b.add_argument("--count-full-codeword", action="store_true",
                   help="Message_CW=1: count errors over all n bits")
    b.add_argument("--batch", type=int, default=bd.batch_per_device,
                   help="frames per decode call")
    b.add_argument("--no-noise", action="store_true", help="Add_noise=0")
    b.add_argument("--channel", choices=["device", "reference"],
                   default="device",
                   help="reference: the CUDA reference's exact LCG noise "
                        "sequence (host-generated; the same noise as "
                        "cuda_ldpc_tpu's --channel reference)")
    b.add_argument("--packed", action="store_true")
    b.add_argument("--tx", choices=["zero", "random"], default=bd.tx)
    b.add_argument("--engine", choices=["batch", "stream"], default=bd.engine)
    d = bd.sweep
    b.add_argument("--snr", default=None, type=tpu_cli._parse_snr,
                   help=f"start:step:stop (default "
                        f"{d.snr_start}:{d.snr_step}:{d.snr_stop})")
    b.add_argument("--snr-type", choices=["ebn0", "esn0"], default=d.snr_type)
    b.add_argument("--least-error-frames", type=int,
                   default=d.least_error_frames)
    b.add_argument("--least-test-frames", type=int, default=d.least_test_frames)
    b.add_argument("--max-frames", type=int, default=d.max_frames)
    b.add_argument("--display-step", type=int, default=d.display_step)
    b.add_argument("--seed", type=int, default=d.seed)
    b.add_argument("--out-dir", default="results")
    b.add_argument("--checkpoint", default=None,
                   help="JSON checkpoint path for resumable sweeps")
    b.add_argument("--quiet", action="store_true")
    b.add_argument("--profile", default=None, metavar="DIR")

    sub.add_parser("list-codes", help="list registered code assets")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "list-codes":
        return tpu_cli.main(["list-codes"])

    from cuda_ldpc_torch import sim as simmod

    simcfg = cfg.BinarySimConfig(
        code=args.code,
        decoder=cfg.BinaryDecoderConfig(
            max_iters=args.max_iters, alpha=args.alpha, beta=args.beta,
            rule=args.rule, schedule=args.schedule, check=args.check,
            message_only=not args.count_full_codeword, kernel=args.kernel),
        sweep=tpu_cli._sweep_from(args, cfg.BinarySimConfig().sweep),
        batch_per_device=args.batch, add_noise=not args.no_noise,
        tx=args.tx, channel=args.channel, engine=args.engine)
    try:
        for flag, what in [(args.packed, "packed"),
                           (args.profile is not None, "profile")]:
            if flag:
                raise simmod.not_ported(what)
        simmod.check_ported(simcfg)
    except NotImplementedError as e:
        ap.error(str(e))
    simmod.run_binary_sweep(simcfg, device=args.device, out_dir=args.out_dir,
                            checkpoint=args.checkpoint, quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
