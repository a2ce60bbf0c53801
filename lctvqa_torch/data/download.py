"""Dataset acquisition (the port's counterpart of lctvqa/data/download.py):
the VQA v2 annotations and questions and the MS-COCO image zips.

    python -m lctvqa_torch.data.download --list_only    # print the URLs
    python -m lctvqa_torch.data.download --output_dir data/vqa

`urls()` lists them; `download()` fetches each zip not already in place
and unzips it, on a machine with network access. Then `python -m
lctvqa_torch.data.build` (data/build.py) makes the training files.
"""

from __future__ import annotations

import os
import urllib.request
import zipfile
from typing import Dict, List

VQA_URLS: Dict[str, List[str]] = {
    "Annotations": [
        "https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
        "v2_Annotations_Train_mscoco.zip",
        "https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
        "v2_Annotations_Val_mscoco.zip",
    ],
    "Questions": [
        "https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
        "v2_Questions_Train_mscoco.zip",
        "https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
        "v2_Questions_Val_mscoco.zip",
        "https://s3.amazonaws.com/cvmlp/vqa/mscoco/vqa/"
        "v2_Questions_Test_mscoco.zip",
    ],
    "Images": [
        "http://images.cocodataset.org/zips/train2014.zip",
        "http://images.cocodataset.org/zips/val2014.zip",
        "http://images.cocodataset.org/zips/test2015.zip",
    ],
}


def urls() -> List[str]:
    return [u for group in VQA_URLS.values() for u in group]


def download(output_dir: str, groups=("Annotations", "Questions",
                                      "Images")) -> None:
    """Fetch and unzip each group: Annotations/ and Questions/ under
    `output_dir`, the image zips into it (train2014/, val2014/, ...)."""
    for group in groups:
        dest = (os.path.join(output_dir, group) if group != "Images"
                else output_dir)
        os.makedirs(dest, exist_ok=True)
        for url in VQA_URLS[group]:
            zip_path = os.path.join(dest, os.path.basename(url))
            if not os.path.exists(zip_path):
                print(f"downloading {url}")
                urllib.request.urlretrieve(url, zip_path)
            print(f"unzipping {zip_path}")
            with zipfile.ZipFile(zip_path) as zf:
                zf.extractall(dest)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="fetch the VQA v2 and COCO "
                                "zips")
    p.add_argument("--output_dir", type=str, default="data/vqa")
    p.add_argument("--list_only", action="store_true")
    args = p.parse_args(argv)
    if args.list_only:
        print("\n".join(urls()))
    else:
        download(args.output_dir)


if __name__ == "__main__":
    main()
