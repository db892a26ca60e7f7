"""The reduction of a trace to each span's device time: marker kernels
paired with the spans' log of them, and the union of the device records
between each pair."""
from portbench import trace
from portbench.trace import _Event


def ev(name, start, end):
    return _Event(name, float(start), float(end))


def test_a_span_counts_the_union_of_its_records_and_no_host_gap():
    # op: markers at 0-1 and 50-51; kernels 10-20 and 15-30 overlap, 40-45 alone
    device = [ev("k1", 10, 20), ev("k2", 15, 30), ev("k3", 40, 45), ev("k4", 60, 70)]
    markers = [ev(trace.MARK, 0, 1), ev(trace.MARK, 50, 51)]
    spans = trace.span_seconds(device, markers, [("op.a", True), ("op.a", False)])
    assert spans == {"op.a": [25e-6, 1]}  # 10-30 and 40-45; 1-10, 30-40 and 45-50 idle


def test_nested_spans_pair_by_the_log():
    device = [ev("k1", 2, 4), ev("k2", 6, 9), ev("k3", 12, 13)]
    markers = [ev(trace.MARK, 0, 1), ev(trace.MARK, 5, 5.5), ev(trace.MARK, 10, 11),
               ev(trace.MARK, 14, 15)]
    marks = [("layer.x", True), ("op.a", True), ("op.a", False), ("layer.x", False)]
    spans = trace.span_seconds(device, markers, marks)
    assert spans["op.a"] == [3e-6, 1]
    assert spans["layer.x"] == [6e-6, 1]  # all three kernels, not the inner markers


def test_markers_that_do_not_pair_read_nothing():
    markers = [ev(trace.MARK, 0, 1), ev(trace.MARK, 5, 6)]
    assert trace.span_seconds([], markers, [("op.a", True)]) is None
    assert trace.span_seconds([], markers, [("op.a", True), ("op.b", False)]) is None
    assert trace.span_seconds([], markers, [("op.a", True), ("op.a", True)]) is None


def test_spans_off_the_card_launch_no_marker():
    spans = trace.Spans(marked=False)

    class Owner:
        def f(self, x):
            return x + 1
    o = Owner()
    spans.layer(o, "f", "f")
    assert o.f(1) == 2 and spans.marks == []
    spans.restore()
    assert "f" not in o.__dict__
