"""refine_device_ms of the refine cell: device ms a refine between the
marks of the program's `refine` stage, in the window's recorded part
(traffic/train_refine.py)."""


def read(out):
    s = out.get("stages")
    if not s or not s.get("snapshot"):
        return None
    spans = [e["device"] for e in s["snapshot"]["timeline"]
             if e["name"] == "refine" and e["device"] is not None]
    if not spans:
        return None
    return sum(e - b for b, e in spans) * 1e-6 / len(spans)
