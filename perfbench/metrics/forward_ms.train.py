"""Device ms of the train step's forward (step start to the loss value) in the last completed step: the program's lap events, nodes of the replayed graph."""

from perfbench.harness import program


def read(rec):
    return program.lap_ms(rec, 'train.forward')
