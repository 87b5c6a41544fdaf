"""The port's preparation of the benchmark-made cloud key on the card, in
s: the host clock around the blind rotation's key (the rows key, or the
lanes engine's int8 operand on a data-parallel cell) and the keyswitch
operand, synchronised before and after."""


def read(run):
    return run.key_prep_s
