"""The plain references and the comparison that decides ``correct``."""
