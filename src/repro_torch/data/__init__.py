from .synthetic import (PrefixedTokens, SyntheticTokens, batch_specs,
                        frontend_embeds)
