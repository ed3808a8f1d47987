"""The backward pass with the expected counts, per useful band cell: the
forward values read once; the backward recursion and, per transition,
the product of the forward, transition, emission and backward terms
added into its count."""


def cost(S: int, transitions: int):
    return 4 * S, 2 * transitions + S + 3 * transitions
