"""lens_ms of the fisheye cell: device ms a view of the program's
`project.lens` stages, in the eager renders of the dataset's views that
a traced run makes after its window (traffic/train_lens.py)."""

from portbench import stages


def read(out):
    return stages.device_ms(dict(stages=out.get("lens_stages")),
                            "project.lens")
