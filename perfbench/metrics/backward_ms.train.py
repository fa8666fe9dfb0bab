"""Device ms of the train step's backward (loss value to the grads, the dp mean included) in the last completed step."""

from perfbench.harness import program


def read(rec):
    return program.lap_ms(rec, 'train.backward')
