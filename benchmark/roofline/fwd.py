"""The forward pass, per useful band cell: the cell's S fp32 forward
values written once for the backward pass to read; per transition one
multiply-add, and one emission multiply per state."""


def cost(S: int, transitions: int):
    return 4 * S, 2 * transitions + S
