"""Host-side index construction and the persisted index format."""
