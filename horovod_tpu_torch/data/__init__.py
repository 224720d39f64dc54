"""Input pipeline helpers of the ported slice."""
