"""reforge-tpu: an image-processing graph engine in JAX, run on GPUs.

A framework with the capabilities of calkhaz/reforge (a Vulkan
compute-shader graph engine): a tiny pipeline DSL describes a filter graph;
each node compiles to a JAX image kernel; the whole graph fuses into a
single XLA-jitted program; configs and kernels live-reload with
keep-last-good error handling; images decode/encode on the host via a native
libav extension; output goes to a live preview or an image file.

See SURVEY.md for the structural analysis of the reference and BASELINE.md
for performance targets.
"""

__version__ = "0.1.0"
