#!/usr/bin/env python3
"""Why the band phase of chip_smoke.py does not solve gen_band's own
matrix: factor tests/test_band.py's ``gen_band`` shape (a Gaussian band
with kl = ku = 512 plus 4 I, ``testing.band_general_system`` with its
default shift) at n = 16384, f32, tiles 512, on the card (an empty
tune cache: the panels take the cold route), and print the
row swaps of its partial pivoting and gecondest's estimate of its
1-norm condition number, beside the same for chip_smoke.py's system
(rows permuted within groups of 256).

    python3 chip_gen_band.py [--seed S]

Prints one JSON object; exits with another code than 0 without a card.
"""

import argparse
import json
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_gen_band: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from slate_tpu_torch.testing import band_general_system
    st = cs.st
    cs.fresh_tune_cache()
    out = {"n": cs.N, "kl": cs.KL, "ku": cs.KU, "tiles": cs.NB,
           "seed": args.seed}
    for name, kw in (("gen_band", {}),
                     ("chip_smoke", {"shift": cs.BAND_SHIFT,
                                     "group": cs.BAND_GROUP})):
        a, _ = band_general_system(args.seed + 1, cs.N, cs.KL, cs.KU, 1,
                                   "cuda", **kw)
        A = st.BandMatrix(cs.KL, cs.KU, a, mb=cs.NB)
        F = st.gbtrf(A)
        moved, least, steps = cs.band_swaps(F.pivots, cs.N, cs.NB)
        out[name] = {"shift": kw.get("shift", 4.0),
                     "group": kw.get("group", 0), "swaps": moved,
                     "least_swaps_a_step": least,
                     "steps_with_a_swap": steps,
                     "kappa1": cs.kappa1(A, F)}
        del a, A, F
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
