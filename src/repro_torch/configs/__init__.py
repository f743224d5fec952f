"""Per-architecture LM configs (the exact assigned dimensions): shapes and
hyper-parameters only, no weights."""
