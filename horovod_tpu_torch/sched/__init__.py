"""Bucketed gradient-exchange scheduler: plan, readiness hooks, execute."""
