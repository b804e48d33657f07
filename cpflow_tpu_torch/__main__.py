"""Command-line interface (counterpart of cpflow_tpu/__main__.py):

    python -m cpflow_tpu_torch synthesize --target toff3 --layer chain \
        --static --num-cp-gates 12 --num-samples 100 --accepted-cz 8
    python -m cpflow_tpu_torch synthesize --qasm circuit.qasm \
        --layer connected --adaptive --min-cp 20 --max-cp 60 --max-evals 50
    python -m cpflow_tpu_torch info

The flags, the named targets and the output JSON are the JAX CLI's. One
flag more, ``--device`` (default cuda): the synthesis runs on the card
unless asked for the CPU (``--device cpu``). With several cards visible,
the sampling sweeps split their restarts over all of them
(``Synthesize(mesh='auto')``).
"""

from __future__ import annotations

import argparse
import json
import sys


def _named_targets():
    from cpflow_tpu_torch.ops import gates
    return {
        'cz': (gates.cz_mat, 2),
        'toff3': (gates.u_toff3, 3), 'toff4': (gates.u_toff4, 4),
        'toff5': (gates.u_toff5, 5),
        'ccz': (gates.u_ccz3, 3), 'cccz': (gates.multi_controlled_z(4), 4),
        'ccccz': (gates.multi_controlled_z(5), 5),
    }


def _target_from_args(args):
    import numpy as np

    if args.qasm:
        from cpflow_tpu_torch.circuits.ir import Circuit
        qc = Circuit.from_qasm_file(args.qasm)
        return qc.unitary().astype(np.complex64), qc.num_qubits
    named = _named_targets()
    if args.target in named:
        return named[args.target]
    raise SystemExit(f'unknown --target {args.target!r}; '
                     f'choose from {sorted(named)} or pass --qasm')


def _layer_from_args(args, num_qubits):
    from cpflow_tpu_torch import topology
    layers = {'chain': topology.chain_layer,
              'connected': topology.connected_layer,
              'star': topology.star_layer}
    if args.layer not in layers:
        raise SystemExit(f'unknown --layer {args.layer!r}; '
                         f'choose from {sorted(layers)}')
    return layers[args.layer](num_qubits)


def cmd_synthesize(args):
    from cpflow_tpu_torch import AdaptiveOptions, StaticOptions, Synthesize

    target, n = _target_from_args(args)
    layer = _layer_from_args(args, n)
    label = args.label or (args.target or 'qasm')
    s = Synthesize(layer, target_unitary=target, label=label,
                   device=args.device)

    if args.adaptive:
        options = AdaptiveOptions(
            min_num_cp_gates=args.min_cp, max_num_cp_gates=args.max_cp,
            num_samples=args.num_samples, max_evals=args.max_evals,
            random_seed=args.seed, bucketed=args.bucketed,
            stop_if_target_reached=args.target_cz is not None,
            target_num_cz_gates=args.target_cz or 0)
        results = s.adaptive(options, save_results=not args.no_save)
    else:
        if args.num_cp_gates is None:
            raise SystemExit('--static requires --num-cp-gates')
        options = StaticOptions(
            num_cp_gates=args.num_cp_gates, r=args.r,
            num_samples=args.num_samples, random_seed=args.seed,
            accepted_num_cz_gates=args.accepted_cz
            if args.accepted_cz is not None else 10 ** 9)
        results = s.static(options, save_results=not args.no_save)

    out = []
    for d in results.decompositions:
        if args.refine:
            d.refine()
        out.append({'cz_count': d.cz_count, 'cz_depth': d.cz_depth,
                    'loss': float(d.loss), 'type': d.type,
                    't_count': d.t_count, 't_depth': d.t_depth})
        if args.print_circuits:
            print(d.circuit.draw(), file=sys.stderr)
    print(json.dumps({'label': label, 'decompositions': out}))


def cmd_info(args):
    import torch
    import cpflow_tpu_torch
    from cpflow_tpu_torch.kernels import build
    cards = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        major, minor = torch.cuda.get_device_capability(i)
        cards.append({'index': i, 'name': torch.cuda.get_device_name(i),
                      'compute_capability': f'{major}.{minor}'})
    print(json.dumps({
        'version': cpflow_tpu_torch.__version__,
        'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'devices': cards,
        'kernel_build_dir': str(build.BUILD_DIR),
        'kernel_source_digest': build.digest(),
    }))


def main(argv=None):
    p = argparse.ArgumentParser(prog='cpflow_tpu_torch')
    sub = p.add_subparsers(dest='cmd', required=True)

    ps = sub.add_parser('synthesize', help='synthesize a unitary into CZ+1q')
    ps.add_argument('--target',
                    help='named target (cz/toff3/toff4/toff5/ccz/cccz/ccccz)')
    ps.add_argument('--qasm', help='OpenQASM 2.0 file defining the target')
    ps.add_argument('--layer', default='chain',
                    help='connectivity: chain|connected|star')
    ps.add_argument('--label', default='')
    mode = ps.add_mutually_exclusive_group()
    mode.add_argument('--static', action='store_true')
    mode.add_argument('--adaptive', action='store_true')
    ps.add_argument('--num-cp-gates', type=int, default=None)
    ps.add_argument('--r', type=float, default=0.00055)
    ps.add_argument('--accepted-cz', type=int, default=None)
    ps.add_argument('--min-cp', type=int, default=10)
    ps.add_argument('--max-cp', type=int, default=40)
    ps.add_argument('--max-evals', type=int, default=20)
    ps.add_argument('--target-cz', type=int, default=None)
    ps.add_argument('--bucketed', action='store_true',
                    help='one padded template for all template lengths '
                         '(adaptive)')
    ps.add_argument('--num-samples', type=int, default=100)
    ps.add_argument('--seed', type=int, default=0)
    ps.add_argument('--refine', action='store_true',
                    help='refine decompositions to Rational/Clifford+T')
    ps.add_argument('--print-circuits', action='store_true')
    ps.add_argument('--no-save', action='store_true')
    ps.add_argument('--device', default='cuda',
                    help='where the sweeps run: cuda (default) or cpu')
    ps.set_defaults(func=cmd_synthesize)

    pi = sub.add_parser('info', help='print versions, cards and the kernel '
                                     'build')
    pi.set_defaults(func=cmd_info)

    args = p.parse_args(argv)
    args.func(args)


if __name__ == '__main__':
    main()
