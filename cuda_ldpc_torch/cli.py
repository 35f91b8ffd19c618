"""Command-line interface of the port (counterpart of
cuda_ldpc_tpu/cli.py:21-222: the ``binary``, ``nb`` and ``list-codes``
subcommands).

Usage:
  python -m cuda_ldpc_torch binary --code J15_L30_Z1280 --snr 2:0.2:3
  python -m cuda_ldpc_torch binary --schedule layered --rule bp ...
  python -m cuda_ldpc_torch binary --device cpu --code J4_L24_Z96 ...
  python -m cuda_ldpc_torch binary --code PON_LDPC --packed --snr 0:0.2:13 ...
  python -m cuda_ldpc_torch binary --engine stream --stream-steps 16 ...
  python -m cuda_ldpc_torch nb --code BDS.576.288.GF.64 --method layered_qspa ...
  python -m cuda_ldpc_torch nb --packed --engine stream ...
  python -m cuda_ldpc_torch binary|nb --profile DIR ...   (batch engine)
  python -m cuda_ldpc_torch list-codes

Options the port does not run yet are still parsed, so that their values
are rejected with the ROADMAP.md item that ports them rather than with a bare
usage error.
"""

from __future__ import annotations

import argparse
import sys

from cuda_ldpc_torch import config as cfg
from cuda_ldpc_torch.utils import registry


def _parse_snr(spec: str):
    try:
        parts = [float(p) for p in spec.split(":")]
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid SNR spec {spec!r}: must be 'x' or 'start:step:stop'")
    if len(parts) == 1:
        return parts[0], 1.0, parts[0]
    if len(parts) == 3:
        return parts[0], parts[1], parts[2]
    raise argparse.ArgumentTypeError("SNR spec must be 'x' or 'start:step:stop'")


def _add_sweep_args(p, d: cfg.SweepConfig):
    p.add_argument("--device", default="cuda",
                   help="cpu, cuda or cuda:N (no fallback: cuda without a "
                        "card is an error)")
    p.add_argument("--kernel", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="auto: the CUDA kernel on a CUDA device, plain "
                        "PyTorch on the CPU")
    p.add_argument("--snr", default=None, type=_parse_snr,
                   help=f"start:step:stop (default "
                        f"{d.snr_start}:{d.snr_step}:{d.snr_stop})")
    p.add_argument("--snr-type", choices=["ebn0", "esn0"], default=d.snr_type)
    p.add_argument("--least-error-frames", type=int,
                   default=d.least_error_frames)
    p.add_argument("--least-test-frames", type=int, default=d.least_test_frames)
    p.add_argument("--max-frames", type=int, default=d.max_frames)
    p.add_argument("--display-step", type=int, default=d.display_step)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--checkpoint", default=None,
                   help="JSON checkpoint path for resumable sweeps")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace batch 1 of each SNR point with torch.profiler "
                        "into DIR/<kind>_snr<snr>/trace.json (the batch "
                        "engine only)")


PACKED_HELP = ("run all SNR points at once: each batch (or the stream's "
               "slot pool) is shared by the unfinished points")


def _add_engine_args(p, d):
    p.add_argument("--engine", choices=["batch", "stream"], default=d.engine,
                   help="stream: continuous batching, a finished frame leaves "
                        "its slot at once and a fresh one takes it (the CUDA "
                        "stream kernel on a card, refilled per call; the "
                        "plain version refilled per iteration)")
    p.add_argument("--stream-steps", type=int, default=d.stream_steps,
                   help="decoder iterations per stream call")


def _sweep_from(args, d: cfg.SweepConfig) -> cfg.SweepConfig:
    s = cfg.SweepConfig(
        snr_type=args.snr_type, least_error_frames=args.least_error_frames,
        least_test_frames=args.least_test_frames, max_frames=args.max_frames,
        display_step=args.display_step, seed=args.seed,
        snr_start=d.snr_start, snr_step=d.snr_step, snr_stop=d.snr_stop)
    if args.snr:
        s.snr_start, s.snr_step, s.snr_stop = args.snr
    return s


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cuda_ldpc_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("binary", help="binary QC-LDPC FER sweep")
    bd = cfg.BinarySimConfig()
    b.add_argument("--code", default="J15_L30_Z1280",
                   choices=registry.BINARY_CODES, metavar="CODE")
    b.add_argument("--schedule", choices=["flooding", "layered"],
                   default=bd.decoder.schedule)
    b.add_argument("--rule", choices=["minsum", "bp"], default=bd.decoder.rule,
                   help="CN update rule: minsum (decoder_method=0) or bp "
                        "(exact sum-product, on true LLRs 2y/sigma^2 — the "
                        "reference's declared but unimplemented "
                        "decoder_method=1, define.cuh:33-34)")
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
    b.add_argument("--packed", action="store_true", help=PACKED_HELP)
    b.add_argument("--tx", choices=["zero", "random"], default=bd.tx)
    b.add_argument("--msg-dtype", default=bd.decoder.msg_dtype,
                   choices=["float32", "bfloat16"])
    _add_engine_args(b, bd)
    _add_sweep_args(b, bd.sweep)

    n = sub.add_parser("nb", help="non-binary GF(q) LDPC FER sweep")
    nd = cfg.NBSimConfig()
    n.add_argument("--code", default=nd.code, choices=registry.NB_CODES,
                   metavar="CODE")
    n.add_argument("--method", default=nd.decoder.method,
                   choices=["ems", "ems_full", "qspa", "layered_qspa",
                            "glayered_qspa", "tmm", "layered_tmm",
                            "glayered_tmm"],
                   help="decoder: ems (the reference's default, Nm/Nc "
                        "below), ems_full (every configuration, the "
                        "reference's decoder_method 2; no Nm/Nc), tmm, "
                        "layered_tmm, glayered_tmm (max domain) or qspa, "
                        "layered_qspa, glayered_qspa (exact sum-product); "
                        "on a card, ems (any --nm/--nc), ems_full, tmm "
                        "and layered_tmm run the kernel csrc/nbms.cu on "
                        "the adjacency codes")
    n.add_argument("--nm", type=int, default=nd.decoder.nm,
                   help="EMS: slots per edge in the configuration sets "
                        "(EMS_NM; Nm - 1 <= q); the card's kernel runs "
                        "every value the plain version takes")
    n.add_argument("--nc", type=int, default=nd.decoder.nc,
                   help="EMS: edges that may deviate (EMS_NC, >= 1); the "
                        "card's kernel runs every value")
    n.add_argument("--max-iters", type=int, default=nd.decoder.max_iters)
    n.add_argument("--n-qam", type=int, default=nd.n_qam,
                   choices=[2, 64, 256])
    n.add_argument("--batch", type=int, default=nd.batch_per_device,
                   help="frames per decode call")
    n.add_argument("--tx", choices=["zero", "fixture", "random"],
                   default=nd.tx)
    n.add_argument("--packed", action="store_true", help=PACKED_HELP)
    _add_engine_args(n, nd)
    _add_sweep_args(n, nd.sweep)

    sub.add_parser("list-codes", help="list registered code assets")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cmd == "list-codes":
        print("binary QC-LDPC codes:")
        for c in registry.BINARY_CODES:
            print("  ", c)
        print("non-binary GF(q) codes:")
        for c in registry.NB_CODES:
            print("  ", c)
        return 0

    from cuda_ldpc_torch import sim as simmod

    if args.cmd == "nb":
        return _main_nb(ap, args, simmod)
    simcfg = cfg.BinarySimConfig(
        code=args.code,
        decoder=cfg.BinaryDecoderConfig(
            max_iters=args.max_iters, alpha=args.alpha, beta=args.beta,
            rule=args.rule, schedule=args.schedule, check=args.check,
            message_only=not args.count_full_codeword, kernel=args.kernel,
            msg_dtype=args.msg_dtype),
        sweep=_sweep_from(args, cfg.BinarySimConfig().sweep),
        batch_per_device=args.batch, add_noise=not args.no_noise,
        tx=args.tx, channel=args.channel, engine=args.engine,
        stream_steps=args.stream_steps)
    try:
        simmod.check_ported(simcfg)
        simmod.check_profile(args.profile,
                             "packed" if args.packed else args.engine)
    except (NotImplementedError, ValueError) as e:
        ap.error(str(e))
    run = {(False, "batch"): simmod.run_binary_sweep,
           (False, "stream"): simmod.run_binary_sweep,
           (True, "batch"): simmod.run_binary_sweep_packed,
           (True, "stream"): simmod.run_binary_stream_packed}
    run[args.packed, args.engine](simcfg, device=args.device,
                                  out_dir=args.out_dir,
                                  checkpoint=args.checkpoint, quiet=args.quiet,
                                  profile_dir=args.profile)
    return 0


def _main_nb(ap, args, simmod) -> int:
    simcfg = cfg.NBSimConfig(
        code=args.code,
        decoder=cfg.NBDecoderConfig(method=args.method, nm=args.nm,
                                    nc=args.nc, max_iters=args.max_iters,
                                    kernel=args.kernel),
        sweep=_sweep_from(args, cfg.NBSimConfig().sweep),
        n_qam=args.n_qam, batch_per_device=args.batch, tx=args.tx,
        engine=args.engine, stream_steps=args.stream_steps)
    try:
        simmod.check_nb_ported(simcfg)
        simmod.check_profile(args.profile,
                             "packed" if args.packed else args.engine)
    except (NotImplementedError, ValueError) as e:
        ap.error(str(e))
    run = {(False, "batch"): simmod.run_nb_sweep,
           (False, "stream"): simmod.run_nb_sweep,
           (True, "batch"): simmod.run_nb_sweep_packed,
           (True, "stream"): simmod.run_nb_stream_packed}
    run[args.packed, args.engine](simcfg, device=args.device,
                                  out_dir=args.out_dir,
                                  checkpoint=args.checkpoint, quiet=args.quiet,
                                  profile_dir=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
