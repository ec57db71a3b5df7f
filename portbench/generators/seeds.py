"""One seed for each system of a pool, derived from the run's seed, so
that any system can be made again on its own (the check makes the inputs
anew rather than read what the program held)."""

import hashlib


def system_seed(seed: int, index: int) -> int:
    h = hashlib.sha256(b"portbench:%d:%d" % (seed, index)).digest()
    return int.from_bytes(h[:8], "little") >> 1
