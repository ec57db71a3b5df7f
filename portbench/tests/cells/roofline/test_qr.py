"""Test only: the classical count of a Householder least-squares solve of
an m x n A with nrhs right-hand sides: 2 m n^2 - 2/3 n^3 for the
factor, 4 m n nrhs - 2 n^2 nrhs for applying Q^T, n^2 nrhs for the
triangular solve."""


def call_flops(config, traffic):
    m, n, k = config["m"], config["n"], traffic["nrhs"]
    return (2.0 * m * n * n - 2.0 / 3.0 * n ** 3
            + 4.0 * m * n * k - 2.0 * n * n * k + n * n * k)
