"""The backward pass with the match posterior, per useful band cell: the
forward values read once and the posterior written once; the backward
recursion (one multiply-add per transition, one emission multiply per
state) and the posterior's product and scale."""


def cost(S: int, transitions: int):
    return 4 * S + 4, 2 * transitions + S + 2
