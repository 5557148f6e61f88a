"""numpy-only synthetic identities and scenes (no training in this package)."""
