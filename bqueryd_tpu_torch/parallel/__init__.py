"""Host-side merge of result payloads."""
