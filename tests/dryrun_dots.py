"""The dot FLOPs of one dry-run cell, product by product, in both
packages: the JAX package's compiled HLO (each `dot` by its operand
shapes, times its enclosing loops' trip counts, walked as
`repro.launch.hlo_analysis.analyze` walks it) and the port's count by op
and local operand shapes (`repro_torch.launch.step_analysis`,
`dot_by_op`). It names the products behind a ratio of the two counts.

    REPRO_ARTIFACTS=/some/tmp JAX_PLATFORMS=cpu PYTHONPATH=src \\
        python tests/dryrun_dots.py codeqwen1.5-7b train_4k [--multipod]

Each package prints its total and its largest products, largest first;
`--port-only` skips the JAX package (for another torch's count).
"""

from __future__ import annotations

import argparse
import re
from collections import defaultdict


def reference_dots(arch: str, shape: str, multi_pod: bool
                   ) -> tuple[float, dict]:
    """(the JAX package's `hlo_dot_flops`, {dot: FLOPs})."""
    from repro.launch import dryrun as D
    from repro.launch import hlo_analysis as H

    lowered, _ = D.lower_cell(arch, shape, multi_pod)
    text = lowered.compile().as_text()
    comps, entry = H.parse_hlo(text)
    dots, cur, symtab = defaultdict(list), None, {}
    for raw in text.splitlines():
        if not raw.strip():
            continue
        if not raw.startswith(" ") and raw.rstrip().endswith("{") \
                and "->" in raw:
            cur = re.match(r"^(ENTRY\s+)?%?([\w\.\-]+)", raw).group(2)
            symtab = {}
            continue
        if raw.startswith("}"):
            cur = None
            continue
        d = H._DEF_RE.match(raw.strip()) if cur else None
        if not d:
            continue
        name, rhs = d.group(1), d.group(2)
        shapes = H._shapes_in(rhs.split("(", 1)[0])
        if shapes:
            symtab[name] = shapes[0][2]
        op = H._OP_RE.search(rhs)
        if not op or op.group(1) != "dot":
            continue
        a, b = (x.strip().lstrip("%") for x in re.search(
            r"dot\(([^)]*)\)", rhs).group(1).split(",")[:2])
        cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rhs)
        k = 1
        for i in (cd.group(1).split(",") if cd and cd.group(1) else []):
            k *= symtab[a][int(i)]
        out = 1
        for x in (shapes[0][2] if shapes else []):
            out *= x
        dots[cur].append((f"dot {symtab.get(a)} {symtab.get(b)}",
                          2 * k * out))

    def walk(comp: str, depth: int = 0) -> dict:
        """{dot: FLOPs} of `comp`, loops times their trip counts."""
        out = defaultdict(float)
        if depth > 64 or comp not in comps:
            return out
        c = comps[comp]
        for key, flops in dots.get(comp, []):
            out[key] += flops

        def add(part, mult=1):
            for key, flops in part.items():
                out[key] += flops * mult

        for cond, body in c.whiles:
            trip = H._trip_count(comps, cond)
            add(walk(body, depth + 1), trip)
            add(walk(cond, depth + 1), trip)
        for f in c.fusions + c.calls:
            add(walk(f, depth + 1))
        for branches in c.conditionals:
            # the branch with the most dot FLOPs (analyze() takes the
            # largest FLOPs + bytes)
            add(max((walk(b, depth + 1) for b in branches),
                    key=lambda d: sum(d.values())))
        return out

    return H.analyze(text).dot_flops, dict(walk(entry))


def port_dots(arch: str, shape: str, multi_pod: bool) -> tuple[int, dict]:
    """(the port's `dot_flops`, its `dot_flops_by_op`)."""
    from repro_torch.launch import dryrun as DR

    res = DR.run_cell(arch, shape, multi_pod, device="cpu")
    if res["status"] != "ok":
        raise RuntimeError(f"{arch} {shape}: {res}")
    return res["dot_flops"], res["dot_flops_by_op"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--multipod", action="store_true",
                    help="the (2, 16, 16) mesh (else 16x16)")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args(argv)
    runs = [("port", port_dots)]
    if not args.port_only:
        runs.insert(0, ("reference", reference_dots))
    for who, fn in runs:
        flops, by = fn(args.arch, args.shape, args.multipod)
        print(f"{who} {args.arch} {args.shape} "
              f"{'2x16x16' if args.multipod else '16x16'}: dot FLOPs "
              f"{flops:.6e}, "
              f"{len(by)} products")
        for key, f in sorted(by.items(), key=lambda kv: -kv[1])[:args.top]:
            print(f"  {f:.4e}  {100 * f / flops:5.1f}%  {key}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
