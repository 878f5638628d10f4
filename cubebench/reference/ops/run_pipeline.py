"""The reference of ``run_pipeline`` (``reference/pipeline.py``): a step
over the whole cube, its products compared by ``pipeline.compare``."""

from cubebench.reference import pipeline

KIND = "cube"


def apply(x, config, op, draw, arith):
    return pipeline.apply(x, config, op, draw, arith)


compare = pipeline.compare
