"""One dry-run cell's per-device flops by op and model call site, times
the mesh size (the global work each site is charged):

    PYTHONPATH=src python scripts/dryrun_sites.py ARCH SHAPE single|multi \\
        OUT.json [--reduced] [--vocab-chunk N]

Prints the cell's per-device and global flops and its collective bytes
by kind, and writes {"op|site|output placements|operands": flops} to
OUT.json. Two meshes' files, compared site by site, show which product a
mesh repeats. `--vocab-chunk` runs the LM train step's loss with those
chunks in place of the step's 512 (0: one chunk), by patching the call:
the package has no such option.
"""
import argparse
import collections
import json
import traceback

import torch

import repro_torch.roofline.analyze as analyze
from repro_torch.launch import dryrun
from repro_torch.models.transformer import TransformerLM


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=["single", "multi"])
    ap.add_argument("out")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--vocab-chunk", type=int, default=None)
    args = ap.parse_args()

    if args.vocab_chunk is not None:
        loss = TransformerLM.loss

        def chunked(self, *a, **kw):
            kw["vocab_chunk"] = args.vocab_chunk
            return loss(self, *a, **kw)
        TransformerLM.loss = chunked

    by_site = collections.Counter()
    charge = analyze.OpCost._charge

    def counted(self, func, name, fargs, kwargs, out):
        flops = analyze._mm_flops(func, fargs) * analyze._flop_share(out)
        if flops:
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch/models" in f.filename]
            site = " <- ".join(
                f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                for f in frames[-2:][::-1]) or "backward"
            operands = [(tuple(a.shape), str(getattr(a, "placements", "")))
                        for a in fargs[:2]]
            key = "|".join((name, site, str(getattr(out, "placements", "")),
                            str(operands)))
            by_site[key] += flops
        return charge(self, func, name, fargs, kwargs, out)
    analyze.OpCost._charge = counted

    rec = dryrun.run_cell(args.arch, args.shape, args.mesh == "multi",
                          args.out + ".records", use_reduced=args.reduced)
    n, r = rec["num_chips"], rec["roofline"]
    print(json.dumps({"torch": torch.__version__, "cell": rec["cell"],
                      "vocab_chunk": args.vocab_chunk,
                      "per_device_flops": r["per_device_flops"],
                      "global_flops": r["per_device_flops"] * n,
                      "collective_breakdown": r["collective_breakdown"],
                      "per_device_total": rec["memory"]["per_device_total"],
                      "seconds": rec["lower_s"] + rec["compile_s"]}))
    with open(args.out, "w") as f:
        json.dump({k: v * n for k, v in by_site.most_common()}, f, indent=0)


if __name__ == "__main__":
    main()
