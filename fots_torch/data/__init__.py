"""Host-side data readers of the port."""
