"""Device ms of the train step's AdamW update and step counter in the last completed step."""

from perfbench.harness import program


def read(rec):
    return program.lap_ms(rec, 'train.optimizer')
