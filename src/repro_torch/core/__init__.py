"""Layout, blockwise operators, execution backends and the blocked encoder."""
