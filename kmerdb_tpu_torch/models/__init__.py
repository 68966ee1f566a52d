"""The database data model and its host builder."""
