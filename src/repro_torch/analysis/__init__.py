"""Analysis tools: the paper's analytic cost model (:mod:`analytic`), with
the H100's data-sheet constants; the meta-device counterpart of "lower and
compile" (:mod:`aot`), which runs one step on meta tensors and records its
FLOPs, collectives and memory; and the roofline report over the dry run's
records (:mod:`roofline`)."""
